#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cfgpp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine
                                 # with an H100, nvcc and PyTorch for CUDA

Phases, one status line each; any failure exits non-zero:

1. card: the card's name and power limit (nvidia-smi), then the build of
   every CUDA library from the sources in this checkout (one nvcc per
   source, all started together).
2. kernels: each kernel against its plain PyTorch version at the shapes the
   slices give it (bf16 inputs from a seed; the f32 attention kernel at the
   same shapes in f32), with the tolerance stated; both times per call
   beside the work's bound on the card (``cfgpp_tpu_torch/utils/
   roofline.py``) and, for the attention, the time of
   ``scaled_dot_product_attention`` on the same inputs and the backend that
   served it: flash_attention_hd, flash_attention_qkv_packed (bf16 and f32),
   int8_matmul (every mode the int8 slices use), int8_ff_geglu,
   int8_conv3x3 (the four SD-1.5 sites of ``--quant all``, and the
   GroupNorm prologue with the residual) and the int8-score attention
   (packed at level 1, unpacked at d=40); then the same kernels at sd21_v's
   768^2 shapes (phase 8's path: head dim 64 at 9216/2304/576/144 tokens
   with 5/10/20/20 heads, the cross k/v from a 1024-wide context, the VAE's
   d=512 attention at 9216 tokens in bf16 and in f32, proj_in's affine
   prologue, the one 768^2 conv int8_conv3x3_supported admits and the
   level-1 int8 score); then at SDXL's 1024^2 shapes (phase 9's path: head
   dim 64 at 4096 tokens with 10 heads and 1024 with 20, the cross k/v from
   a 2048-wide context, the VAE's d=512 attention at 16384 tokens in bf16
   and in f32, the int8 matmuls and feed-forwards at 640 and 1280
   channels, the 16 distinct shapes of the 35 admitted 3x3 convs, 128-wide
   latent rows among them, and the int8 score at both levels); then the
   level-1 and level-2 self- and cross-attention at batch 1 (phase 10's
   single-branch Lightning forms), with the grid the kernel picks there;
   then the same sites at batch 16 (phase 11's UNet calls: 8 prompts, cond
   and uncond) with the grid, and rows 0-1 and 14-15 of each batch-16 call
   bit for bit a batch-2 call on those rows.
   Each model's rows keep their own per-request sums.  The int8
   kernels are also held stage by stage: their int8 rows (conv: windows,
   attention: q and k) and scales against the plain quantizers, the
   feed-forward's f32 hidden state and its requantize, and each GEMM and
   epilogue against the plain one run from the kernel's own int8 values.
   Beside the int8 GEMMs, ``torch._int_mm`` on the same int8 operands times
   the bare int8 product as a yardstick for the GEMM core.  Every int8
   entry point is also held in f32 (f32 activations in and out, its own
   ``_f32`` row of the table), with the same stage checks.
3. exact slice: SD-1.5 ``ddim_cfg++``, lambda=0.6, 50 NFE, 512^2, random
   weights from seed 0, bf16, three requests of batch 1 through
   ``DiffusionEngine.sample``.  Checks the images, the kernel launch count
   per request, and one UNet call and one VAE decode against the same
   modules with the plain attention in place of the kernel.
4. int8 slice: the same requests with the UNet quantized by the port
   (``--quant dense``: int8 W8A8 transformer projections).  Checks the
   images, the launches per request of each of the four kernels, one
   quantized UNet call against the same modules with every kernel's plain
   version, the quant-drift gate of ``python -m
   cfgpp_tpu_torch.cli.parity_check --quant_drift`` (its
   ``drift_summary``, the JAX CLI's rule: worst per-step rel-MAE of the
   first int8 request's trajectory against the first exact request's, from
   the same prompt, seed and zT, < 0.15),
   and peak device memory.
5. int8-all slice: the same requests with ``--quant all`` (the int8 UNet of
   phase 4 plus int8 resnet and upsampler convs and the int8-score
   self-attention where the JAX route takes them).  The same checks, with
   the launches of all seven kernel entry points per request.
6. f32: the VAE encode of a 512^2 image (f32 by design) and one UNet call
   of an f32 bundle at 512^2 (``--dtype float32``), each with the f32
   attention kernel against the same modules with the plain attention, and
   the kernel's launches in each; then one f32 ``--quant dense`` and one f32
   ``--quant all`` UNet call with the int8 kernels on f32 activations
   against the same modules with every kernel's plain version, with the
   launches of each entry point per call.  The f32 VAE encode and UNet
   call also run once with cuDNN TF32 on (the CLIs' default; the smoke
   turns it off), their rel-L2 against the plain-attention twin printed
   beside the 1e-3 bound.
7. solvers and inversion, on the bf16 bundle of phase 3: every SD solver
   loop (the 14 of the registry, and the inversion loop in both forms; and
   the 5 SDXL-Lightning loops at 4 NFE, trailing timesteps, w=1) run
   with a synthetic eps function on the card at the slice's latent shape,
   held against the same loop on the CPU with the card's noise copied over
   (1e-5 x the latent scale); then one request through
   ``DiffusionEngine.sample`` per new sampling solver (euler, euler_a,
   dpm++_2s_a, dpm++_2m, each in CFG form at w=7.5 and CFG++ form at
   lambda=0.6), and five inversion requests (ddim_inversion,
   ddim_inversion_cfg++, ddim_edit, ddim_edit_cfg++, and
   ddim_inversion_cfg++ with latent_init="npi") of a 512^2 image made from
   a seed, written with ``save_image`` and read back with ``load_image``.
   Checks the images, the attention launches of each request exactly
   (1601 for one UNet call a step, 3169 for DPM++ 2S, 3202 for an
   inversion: 100 UNet calls, the bf16 decode and the f32 encode), and the
   first step of every new kind with the kernel against the same step with
   the plain attention (its UNet call's eps pair by phase 3's bound, the
   guided eps_hat and the step's (z0t, zt) by that bound x max(1, w)).
8. SD-2.x: ``sd21_v`` (SD-2.1 widths and depth: linear-projection
   transformers, the 23-layer 1024-wide gelu CLIP, v-prediction) at 768^2,
   random weights from seed 0, bf16, ``ddim_cfg++`` at lambda=0.6, 50 NFE,
   batch 1, after the SD-1.5 bundle is freed.  One UNet call and one VAE
   decode with the kernel against the plain attention (phase 3's bound);
   the first step's eps pair, eps_hat and (z0t, zt) against the same step
   with the plain attention (phase 7's rules: the v -> eps conversion runs
   on the card); three exact requests, one ``--quant dense`` and one
   ``--quant all`` request (each with its UNet call against every kernel's
   plain version at phases 4-5's bounds, its launches of every entry point
   exactly, its quant drift against the first exact request < 0.15) and
   one ``ddim_inversion_cfg++`` request of a 768^2 image made from the
   seed; s/image and peak device memory of each.
9. SDXL: ``sdxl`` (SDXL base widths and depth: the dual CLIP, the
   text_time added embedding, 10-block transformer stacks) at 1024^2,
   random weights from seed 0, bf16, the JAX bench's op-point
   ``dpm++_2m_cfgpp`` at w=5, 25 NFE (24 UNet calls), batch 1, after the
   sd21_v bundle is freed: phase 8's checks in the same order (UNet call
   and VAE decode, the first step, three exact requests, one ``--quant
   dense`` and one ``--quant all`` request with their UNet calls against
   the plain kernels and their drift), then one ``ddim_edit_cfg++``
   request (lambda=0.6, 25 NFE) of a 1024^2 image made from the seed.
10. SDXL-Lightning: a seeded random ``sdxl_lightning`` bundle (bf16; the
   f32 VAE and CLIPs rounded to bf16 values) written as a full-width SGM
   single file by the port's inverse map (``tools/sgm_synth.py``, about 6.9
   GB), converted by ``python -m cfgpp_tpu_torch.cli.convert_checkpoint``
   (``main``) to the native HF layout (about 8.8 GB) and loaded with
   ``ModelBundle.from_pretrained``: every tensor bit for bit the random
   bundle's, with bytes, seconds and GB/s of each step.  It needs about 17
   GB free in the temporary directory (``TMPDIR``), and checks first.  The
   engine comes from ``cli.common.build_engine`` of the reference's command
   (``--model sdxl_lightning --ckpt_dir D --light_ckpt F --method
   ddim_cfg++_lightning --NFE 4 --cfg_guidance 1``), bit for bit again;
   then the first ``ddim_cfg++_lightning`` and (batch-1) ``ddim_lightning``
   steps against the plain attention, three exact requests (561 launches),
   one ``--quant dense`` request (its UNet call against every kernel's plain
   version, 1348/280/280/281 launches, drift < 0.15), one request each of
   ``ddim_lightning``, ``euler_lightning``, ``euler_cfg++_lightning`` (561)
   and ``dpm++_2m_cfgpp_lightning`` (421) with the batch of every UNet call
   (1 for the CFG forms at w=1), and w=5 refused with the JAX engine's
   message before any launch; s/image and peak device memory of each.  Both
   files are deleted.
11. MS-COCO eval generation: a seeded random ``sdxl`` bundle (bf16) made
   by the CLI's ``build_engine`` and shared by the CLI runs of this phase.
   The README's command through ``python -m
   cfgpp_tpu_torch.cli.text_to_mscoco`` (``main``): ``ddim_cfg++`` at
   lambda=0.6, 50 NFE, ``--batch_size 8`` (UNet batch 16) on 10 prompts the
   phase writes: files 00000-00009.png, each read back as a 1024^2 RGB
   image, none for the padded slots, ``num_images`` 10, exactly 2 x (50 x
   140 + 8) attention launches, img/s, each batch's seconds and the peak
   device memory; ``--resume`` after 00009.png is deleted (the first
   batch's files untouched, 7008 launches, ``num_images`` 2); index 9
   drawn alone by ``sample_batch`` against the batch-8 image (rel-L2 within
   phase 3's bound, and the largest uint8 difference); ranks 0 and 1 of 2
   (``RANK``/``WORLD_SIZE``, one after the other on the one card) at
   ``--num_prompts 2 --batch_size 2``, each writing its one image, held
   against the batch-8 run's by the same bound; then ``text_to_img`` with
   ``--callbacks draw_tweedie draw_noisy --callback_frequency 10`` (the 6
   PNGs of each record directory named by the JAX rule, 7001 + 12
   launches), and the same request without callbacks, with them fused and
   unrolled (bit for bit, or within the spread of two runs of one
   request), and with a callback that halves zt at step 0 (it changes the
   image unrolled, not fused).
12. metrics: ``python -m cfgpp_tpu_torch.cli.calculate_metrics``
   (``main``) with every flag on phase 11's ten images and ``--device
   cuda``: InceptionV3 FID, CLIP ViT-L/14 CLIP-FID and CLIP-score, VGG16
   LPIPS at 1024^2, PSNR/MSE, full width, seeded random weights written in
   the published layouts (``tools/metric_synth.py``: ``.pth`` and a
   combined CLIPModel ``.safetensors``, about 1.9 GB) against paired labels
   (the images plus seeded noise in [-8, 8]): every key finite, 10 pairs,
   PSNR and MSE exactly numpy's, CLIP-score in (0, 100], LPIPS >= 0, no
   kernel of the port launched (no TPU kernel lies on this path); LPIPS of
   the images against themselves exactly 0; the committed JPEG fixtures
   (``tests/data/jpeg/``) decoded bit for bit to their stored PIL decodes,
   then FID and CLIP-FID against them (mixed sizes: the host-resize path);
   the card's Inception, CLIP image and text features and two pairs' LPIPS
   against the port on the CPU (rel-L2 1e-4, TF32 off), FIDs within 1e-3
   relative, a self-FID within 1e-6 of the trace; the CLI's FID and
   CLIP-FID within 1e-3 relative, its CLIP-score and LPIPS within 1e-4, of
   the same metrics from the CPU's features (LPIPS: the card's per-pair
   values), with every text-image cosine positive and the CLIP-score of a
   pairing shifted by one image outside that bound; recorded: the FID with
   cuDNN TF32 on, tower rates, decode and host-resize rates, the CLI's
   wall time, peak device memory, and the projected time of a 10k-image
   FID against COCO's JPEGs.
13. the last modules: ``python -m cfgpp_tpu_torch.cli.text_to_img
   --profile_dir`` (``main``) on sd15 at 512^2, ``ddim_cfg++`` lambda=0.6,
   50 NFE: 1601 launches, and the Chrome trace it writes holds one device
   event of the flash kernel per launch; ``python -m
   cfgpp_tpu_torch.cli.parity_check --dump`` for t2i, inversion and edit on
   dumps of exactly the ``DUMP_SCHEMA`` keys, written by the port's engine
   (sd15, 512^2, bf16, 50 NFE) over a random sd15 bundle saved as an
   HF-layout directory (``save_bundle``) that the CLI loads with
   ``from_pretrained``: each PASS at the CLI's default tolerance, its worst
   MAE printed, its launches exact; ``parity_check --quant_drift`` at its
   default command (sdxl 1024^2, ``dpm++_2m_cfgpp``, 25 NFE, ``all``) and
   with ``--quant_mode dense``: WITHIN-INT8-BUDGET, exit code 0, the worst
   rel-MAE beside phase 9's, the launches exactly an exact and a quantized
   request's; ``python -m cfgpp_tpu_torch.tools.profile_bench``: its
   segment times, modeled total and host time per solver step.
14. summary: the run's wall time, a JSON line of the kernels
   (``launches_by_path`` with the sd21_v, sdxl, sdxl_lightning and MS-COCO
   runs; ``by_model``: each model's per-request sums, ``sdxl_lightning``
   from the sdxl rows at the Lightning calls, ``sdxl_mscoco_b16`` per
   batch of 8 images), then the result line ``{"ok": true, "device":
   {...}}``.

Before its summary, and on every way out, it stops the processes it
started that would outlive it (phase 12's JPEG forkserver and
multiprocessing's resource tracker, which otherwise exit only some time
after this process has) and ends any other process still below it.

Without a CUDA device, or outside the repository, it prints no result and
exits non-zero.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# Tolerances, kernel vs plain version on the same inputs.
# - Attention: the kernel rounds p to bf16 before p@v (as the TPU kernel
#   does) and writes bf16, so its error is a few bf16 ulps of the output
#   scale: max |kernel - plain| <= KERNEL_REL_TOL x max |plain| ("rel").
# - int8: the kernels round every f32 step as the plain versions do, so
#   without a LayerNorm `int8_matmul` is held to exact equality ("exact").
#   A fused LayerNorm sums its statistics in another order than torch, which
#   flips a few int8 levels; there the output is held to the CPU tests' rule
#   ("ulp": no more than ULP_SHARE of the elements beyond one bf16 ulp of
#   the plain output, none beyond KERNEL_REL_TOL x max |plain|).  A flipped
#   level moves its whole output row (and, in the feed-forward, the row's
#   hidden state and requantize), so the rows whose int8 input the
#   LayerNorm flipped are left out of the share: one such row is 1/512 of
#   the outputs at level 2 and 1/128 in SD-1.5's mid block, more than
#   ULP_SHARE (on the H100 a bf16 mid-block FF read 2.74e-3 with all rows
#   counted, 6.2e-6 without its one flipped row).  The
#   stage checks bound the flips (LN_FLIP_SHARE) and hold every later stage
#   exactly.
# - int8 stages: the quantized rows are the plain version's bit for bit
#   without a LayerNorm; with one, no more than LN_FLIP_SHARE of them differ,
#   by one level, and the row scales by SX_REL_TOL (a few f32 ulps).  Every
#   stage after the quantize is held exactly to its plain counterpart run
#   from the kernel's own rows: the GEMM and epilogue, the FF's f32 hidden
#   state (both sides call CUDA's erff) and its requantize (from f32, over
#   all N).
# On the H100 the LayerNorm cases read at most 1.5e-6 of the int8 values
# flipped and 3.5e-4 of the outputs beyond one ulp.
KERNEL_REL_TOL = 2e-2
# - f32 attention: f32 all the way on both sides, so only the summation order
#   and exp2 against exp differ: max |kernel - plain| <= F32_REL_TOL x
#   max |plain| ("f32").
F32_REL_TOL = 1e-4
# - f32 int8 kernels: the TPU kernels write bf16 whatever they read, so the
#   `_f32` entry points round their output to bf16 and store it widened to
#   f32, and so do the plain versions.  Each output is checked to hold bf16
#   values and is held by the bf16 rules: exact without a prologue, "ulp"
#   with one; the f32 int8-score attention (p not rounded on either side)
#   by "ulp" too, and its output must be the bf16 rounding of a value within
#   F32_REL_TOL x max |plain| of the plain version's unrounded f32 result:
#   a kernel that rounded p to bf16 (about 1e-3 relative, below one bf16
#   ulp) would pass "ulp" but not this.
# - bf16 int8-score attention: the kernel computes p max-free with the plain
#   version's steps, so p is bit-equal on both sides and only the f32 order
#   of sum p and p@v differs; it is held by the same two rules as the f32
#   rows ("ulp", and each output the bf16 rounding of a value within
#   F32_REL_TOL x max of the unrounded plain value).
ULP_SHARE = 1e-3
LN_FLIP_SHARE = 1e-4
SX_REL_TOL = 1e-6
# Model vs model: the same bf16 network with the kernels or the plain
# versions in their place, ||kernel path - plain path|| <= tol x ||plain||.
MODEL_REL_L2_TOL = 3e-2
# The int8 UNet at random weights turns every last-bit difference into int8
# level flips: on the H100 (t = 101/501/901) the kernels against the plain
# versions read rel-L2 3.1-3.3e-2, and so do last-bit variants of the plain
# recipe (x/sx, a two-pass variance, the FF hidden state quantized from
# bf16: 2.9-3.3e-2); truncation in place of rounding and 7-bit activations
# read 5.4-5.9e-2.  So this bound catches coarse faults only; the stage
# checks above pin the kernels' numerics down.
INT8_MODEL_REL_L2_TOL = 4e-2
# The int8-all UNet quantizes more (its resnet convs per window of rows, its
# level-1 attention scores), so its last-bit differences flip more int8
# levels: on the H100 (t = 101/501/901) the kernels against the plain
# versions read rel-L2 4.8-5.2e-2, while truncation in place of rounding
# reads 9.0-9.5e-2 and 7-bit activations 8.4-8.9e-2.  The bound sits
# between them.
INT8_ALL_MODEL_REL_L2_TOL = 6.5e-2
# The f32 models with the f32 kernel against the plain attention: a bf16
# route reads about 1e-2 there, so this bound tells the two apart.
F32_MODEL_REL_L2_TOL = 1e-3

NFE = 50
GUIDANCE = 0.6
RESOLUTION = 512
SEED = 42
PROMPTS = ("a photograph of an astronaut riding a horse",
           "a watercolor painting of a lighthouse at dusk")
UNET_SITES_PER_CALL = 32      # 16 transformer blocks x (self + cross)
LAUNCHES_PER_REQUEST = UNET_SITES_PER_CALL * NFE + 1   # + the VAE mid-block
# The f32 path's attention launches: one UNet call runs every transformer
# site through flash_attention_hd (16 self, 16 cross), the encoder one.
F32_LAUNCHES = {"vae encode": 1, "unet eps": UNET_SITES_PER_CALL}
# One f32 int8 UNet call (cross k/v computed in the call): the per-request
# launches of the bf16 int8 slices below, for one of the NFE calls plus the
# cross k/v of the request.
F32_INT8_LAUNCHES_PER_CALL = {
    "dense": {"int8_matmul": 16 * 6 + 16 * 2, "int8_ff_geglu": 16,
              "flash_attention_qkv_packed": 16, "flash_attention_hd": 16},
    "all": {"int8_matmul": 16 * 6 + 16 * 2 + 14, "int8_ff_geglu": 16,
            "int8_conv3x3": 4, "flash_attention_qkv_packed_int8": 5,
            "flash_attention_qkv_packed": 11, "flash_attention_hd": 16,
            "flash_attention_hd_int8": 0},
}
# The int8 slice, per request (16 transformer blocks, one per transformer):
# int8_matmul: to_qkv, attn1 to_out, to_q, attn2 to_out, proj_in, proj_out
# per block and UNet call, + the cross k/v of every block once per request;
# int8_ff_geglu: one per block; packed: every self-attention; hd: every
# cross-attention + the VAE mid-block.
INT8_LAUNCHES_PER_REQUEST = {
    "int8_matmul": 16 * 6 * NFE + 16 * 2,
    "int8_ff_geglu": 16 * NFE,
    "flash_attention_qkv_packed": 16 * NFE,
    "flash_attention_hd": 16 * NFE + 1,
}
QUANT_DRIFT_BUDGET = 0.15     # parity_check --quant_budget's default
# The int8-all slice, per request: the int8 slice's launches, plus per UNet
# call 14 1x1 conv_shortcut int8_matmuls (down blocks 1-2: one each; every
# up resnet), the 4 3x3 convs that int8_conv3x3_supported admits at 512^2
# (CONV_CASES), and the level-1 self-attention (5 blocks) on the int8-score
# kernel instead of the bf16 packed one.
ALL_LAUNCHES_PER_REQUEST = {
    "int8_matmul": INT8_LAUNCHES_PER_REQUEST["int8_matmul"] + 14 * NFE,
    "int8_ff_geglu": 16 * NFE,
    "int8_conv3x3": 4 * NFE,
    "flash_attention_qkv_packed_int8": 5 * NFE,
    "flash_attention_qkv_packed": 11 * NFE,
    "flash_attention_hd": 16 * NFE + 1,
    "flash_attention_hd_int8": 0,
}

# Phase 8: sd21_v (SD-2.1, v-prediction) at 768^2, the same 50-NFE
# ddim_cfg++ requests.  The UNet has SD-1.5's 16 transformer blocks (32
# attention sites a call), head dim 64 at every site.  --quant all: 14
# conv_shortcut int8_matmuls a call as in SD-1.5; of its 47 3x3 convs
# int8_conv3x3_supported admits one at 768^2 (up_blocks.2's upsampler,
# [2, 96, 96, 640] -> 640, br 8: the 48^2 and smaller latents have W no
# multiple of 32, the 96^2 resnets c*o < 640*640); the int8 score applies
# at level 1 only (2304 tokens, 10 heads: level 0's 9216 kv rows exceed one
# TPU block, levels 2 and mid are under FLASH_MIN_Q_LEN).
# tests/test_torch_port_sd2_sites.py derives these from the JAX predicates.
SD2_RESOLUTION = 768
SD2_LAUNCHES_PER_REQUEST = {
    "exact": {"flash_attention_hd": UNET_SITES_PER_CALL * NFE + 1},
    "dense": dict(INT8_LAUNCHES_PER_REQUEST),
    "all": {"int8_matmul": INT8_LAUNCHES_PER_REQUEST["int8_matmul"] + 14 * NFE,
            "int8_ff_geglu": 16 * NFE,
            "int8_conv3x3": 1 * NFE,
            "flash_attention_qkv_packed_int8": 5 * NFE,
            "flash_attention_qkv_packed": 11 * NFE,
            "flash_attention_hd": 16 * NFE + 1},
    "inversion": {"flash_attention_hd": UNET_SITES_PER_CALL * 2 * NFE + 2},
}

# Phase 7.  The new sampling solvers run at the reference CLIs' guidance of
# their form: w=7.5 for CFG, lambda=0.6 for CFG++.
SAMPLING_SOLVERS = ("euler", "euler_cfg++", "euler_a", "euler_a_cfg++",
                    "dpm++_2s_a", "dpm++_2s_a_cfg++", "dpm++_2m",
                    "dpm++_2m_cfg++")
# (solver, latent_init) of the inversion requests.
INVERSION_REQUESTS = (("ddim_inversion", None), ("ddim_inversion_cfg++", None),
                      ("ddim_edit", None), ("ddim_edit_cfg++", None),
                      ("ddim_inversion_cfg++", "npi"))
# flash_attention_hd launches per request: 32 per UNet call, + 1 for the
# VAE decode (bf16), + 1 for the VAE encode (f32) of an inversion.
SOLVER_LAUNCHES_PER_REQUEST = {
    "one call a step": UNET_SITES_PER_CALL * NFE + 1,                # 1601
    "dpm2s": UNET_SITES_PER_CALL * (2 * (NFE - 1) + 1) + 1,          # 3169
    "inversion": UNET_SITES_PER_CALL * 2 * NFE + 2,                  # 3202
}
# The solver loops, card against CPU on the same inputs and noise: f32 on
# both sides, only the devices' f32 rounding (sin, cos, fused multiply-adds)
# differs, so max |card - cpu| <= LOOP_REL_TOL x max(1, max |cpu|).
LOOP_REL_TOL = 1e-5
LOOP_SHAPE = (1, RESOLUTION // 8, RESOLUTION // 8, 4)

# (site, q shape, kv rows, heads, kv_len, calls per request).  Heads are 8
# in every SD-1.5 UNet block; 5 transformer blocks per level (2 down, 3 up),
# 1 in the mid block; one VAE mid-block attention per image.  The calls are
# the exact slice's; in the int8 slice the self-attention rows run packed.
ATTENTION_CASES = [
    ("unet L0 self", (2, 4096, 320), 4096, 8, None, 5 * NFE),
    ("unet L0 cross", (2, 4096, 320), 77, 8, None, 5 * NFE),
    ("unet L1 self", (2, 1024, 640), 1024, 8, None, 5 * NFE),
    ("unet L1 cross", (2, 1024, 640), 77, 8, None, 5 * NFE),
    ("unet L2 self", (2, 256, 1280), 256, 8, None, 5 * NFE),
    ("unet L2 cross", (2, 256, 1280), 77, 8, None, 5 * NFE),
    ("unet mid self", (2, 64, 1280), 64, 8, None, NFE),
    ("unet mid cross", (2, 64, 1280), 77, 8, None, NFE),
    ("vae mid self", (1, 4096, 512), 4096, 1, None, 1),
    ("cross kv padded to 128", (2, 4096, 320), 128, 8, 77, 0),
    ("d=64 (SDXL's head dim; not on the path)", (2, 1024, 640), 1024, 10,
     None, 0),
]
# The int8 slice's shapes: (level, tokens per image, channels, transformer
# blocks); the UNet runs batch 2B = 2.
LEVELS = [("L0", 4096, 320, 5), ("L1", 1024, 640, 5), ("L2", 256, 1280, 5),
          ("mid", 64, 1280, 1)]
# (site, x shape, N, mode, calls per request) for int8_matmul.  Modes: "ln"
# (fused pre-LayerNorm), "bias_res" (bias + residual), "bias", "none",
# "affine" (per-(sample, channel) prologue: SD-2.x's linear proj_in).
INT8_MATMUL_CASES = [
    case for lvl, n, c, blocks in LEVELS for case in (
        (f"{lvl} to_qkv", (2, n, c), 3 * c, "ln", blocks * NFE),
        (f"{lvl} to_q", (2, n, c), c, "ln", blocks * NFE),
        (f"{lvl} attn1/attn2 to_out, proj_out", (2, n, c), c, "bias_res",
         3 * blocks * NFE),
        (f"{lvl} proj_in", (2, n, c), c, "bias", blocks * NFE))
] + [(f"{lvl} cross k/v", (2, 77, 768), c, "none", 2 * blocks)
     for lvl, _, c, blocks in LEVELS] + [
    ("edges: M 100, K 80, N 48 (not on the path)", (1, 100, 80), 48,
     "bias_res", 0)]
# (site, x shape, calls per request) for int8_ff_geglu: N = 4C, O = C.
INT8_FF_CASES = [(f"{lvl} ff", (2, n, c), blocks * NFE)
                 for lvl, n, c, blocks in LEVELS] + [
    ("edges: M 100, C 80 (not on the path)", (1, 100, 80), 0)]
# (site, packed qkv shape, heads, calls per request)
PACKED_CASES = [(f"unet {lvl} self packed", (2, n, 3 * c), 8, blocks * NFE)
                for lvl, n, c, blocks in LEVELS]
# (site, x shape NHWC, O, GroupNorm prologue, residual, scale window rows br,
# calls per request) for int8_conv3x3: the 3x3 convs of the UNet that
# int8_conv3x3_supported admits at 512^2 (br: scale_window_rows), one
# prologue + residual case, and two edge shapes off the path (C and O no
# multiple of the k step or the tile; tiles that straddle windows).
CONV_CASES = [
    ("up_blocks.1 upsampler", (2, 32, 32, 1280), 1280, False, False, 16, NFE),
    ("up_blocks.2 resnets.0 conv1", (2, 32, 32, 1920), 640, True, False, 8,
     NFE),
    ("up_blocks.2 resnets.1 conv1", (2, 32, 32, 1280), 640, True, False, 16,
     NFE),
    ("up_blocks.2 upsampler", (2, 64, 64, 640), 640, False, False, 8, NFE),
    ("prologue + residual (not on the path)", (2, 64, 64, 640), 640, True,
     True, 8, 0),
    ("edges: C 48, O 40, br 1 (not on the path)", (1, 8, 32, 48), 40, False,
     False, 1, 0),
    ("edges: W 48, tiles straddle windows, prologue + residual (not on the"
     " path)", (2, 8, 48, 64), 64, True, True, 2, 0),
]
# (site, shape, heads, packed, calls per request) for the int8-score
# attention: level 1's self-attention, and the unpacked entry point at d=40
# (SD-1.5 256^2 level 0 in the JAX route; not on the 512^2 path).
INT8_ATTENTION_CASES = [
    ("unet L1 self packed", (2, 1024, 3 * 640), 8, True, 5 * NFE),
    ("d=40, 1024 tokens", (2, 1024, 320), 8, False, 0),
]


# The same kernels at sd21_v's 768^2 shapes (phase 8's path): (level, tokens
# per image, channels, heads, transformer blocks); head dim 64 everywhere,
# the cross context 1024 wide.  Calls per request are phase 8's: exact for
# the bf16 attention, dense for the packed and int8 rows, all for the conv
# and the int8 score; the f32 attention at d=512 is the VAE encode of an
# inversion request.
SD2_LEVELS = [("L0", 9216, 320, 5, 5), ("L1", 2304, 640, 10, 5),
              ("L2", 576, 1280, 20, 5), ("mid", 144, 1280, 20, 1)]
SD2_ATTENTION_CASES = [
    case for lvl, n, c, h, blocks in SD2_LEVELS for case in (
        (f"sd21_v {lvl} self", (2, n, c), n, h, None, blocks * NFE),
        (f"sd21_v {lvl} cross", (2, n, c), 77, h, None, blocks * NFE))
] + [("sd21_v vae mid self", (1, 9216, 512), 9216, 1, None, 1)]
SD2_F32_ATTENTION_CASES = [
    ("sd21_v vae mid self (the inversion's f32 encode)", (1, 9216, 512),
     9216, 1, None, 1)]
SD2_PACKED_CASES = [(f"sd21_v {lvl} self packed", (2, n, 3 * c), h,
                     blocks * NFE) for lvl, n, c, h, blocks in SD2_LEVELS]
SD2_INT8_MATMUL_CASES = [
    case for lvl, n, c, _, blocks in SD2_LEVELS for case in (
        (f"sd21_v {lvl} to_qkv", (2, n, c), 3 * c, "ln", blocks * NFE),
        (f"sd21_v {lvl} to_q", (2, n, c), c, "ln", blocks * NFE),
        (f"sd21_v {lvl} attn1/attn2 to_out, proj_out", (2, n, c), c,
         "bias_res", 3 * blocks * NFE),
        (f"sd21_v {lvl} proj_in (GroupNorm as the affine prologue)",
         (2, n, c), c, "affine", blocks * NFE))
] + [(f"sd21_v {lvl} cross k/v", (2, 77, 1024), c, "none", 2 * blocks)
     for lvl, _, c, _, blocks in SD2_LEVELS]
SD2_INT8_FF_CASES = [(f"sd21_v {lvl} ff", (2, n, c), blocks * NFE)
                     for lvl, n, c, _, blocks in SD2_LEVELS]
SD2_CONV_CASES = [("sd21_v up_blocks.2 upsampler", (2, 96, 96, 640), 640,
                   False, False, 8, NFE)]
SD2_INT8_ATTENTION_CASES = [("sd21_v L1 self packed", (2, 2304, 3 * 640), 10,
                             True, 5 * NFE)]
# Phase 9: SDXL (stabilityai/stable-diffusion-xl-base-1.0 widths and depth)
# at 1024^2, the JAX bench's op-point (bench.py:72): dpm++_2m_cfgpp at w=5,
# 25 NFE, which loops timesteps[:-1]: 24 UNet calls a request.  The UNet has
# 70 transformer blocks in 11 transformers (level 1: 2 down + 3 up
# transformers of 2 blocks; level 2: 2 down + 3 up + the mid of 10 blocks;
# level 0 has none), so 140 attention sites a call, head dim 64 everywhere,
# and a 2048-wide cross context.  --quant dense: per call 4 int8_matmuls a
# block and proj_in/proj_out a transformer (302), the cross k/v of every
# block once a request.  --quant all adds the 11 conv_shortcut 1x1
# int8_matmuls a call, the 35 of 36 3x3 convs that int8_conv3x3_supported
# admits (all but down_blocks.1's first conv1, c*o 320*640 at 64^2), and
# every self-attention on the int8-score kernel (4096 and 1024 tokens are
# one TPU kv block each).  ddim_edit_cfg++ at 25 NFE: 25 inversion and 25
# sampling calls, the bf16 decode and the f32 encode (flash_attention_hd
# counts both dtypes).  tests/test_torch_port_sdxl_sites.py derives these
# from the JAX predicates.
SDXL_RESOLUTION = 1024
SDXL_NFE = 25
SDXL_GUIDANCE = 5.0
SDXL_SOLVER = "dpm++_2m_cfgpp"
SDXL_EDIT_SOLVER, SDXL_EDIT_GUIDANCE = "ddim_edit_cfg++", GUIDANCE
SDXL_CALLS = SDXL_NFE - 1
SDXL_BLOCKS, SDXL_TRANSFORMERS = 70, 11
SDXL_SITES_PER_CALL = 2 * SDXL_BLOCKS
SDXL_DENSE_MATMULS = 4 * SDXL_BLOCKS + 2 * SDXL_TRANSFORMERS
SDXL_LAUNCHES_PER_REQUEST = {
    "exact": {"flash_attention_hd": SDXL_SITES_PER_CALL * SDXL_CALLS + 1},
    "dense": {"int8_matmul": SDXL_DENSE_MATMULS * SDXL_CALLS + 2 * SDXL_BLOCKS,
              "int8_ff_geglu": SDXL_BLOCKS * SDXL_CALLS,
              "flash_attention_qkv_packed": SDXL_BLOCKS * SDXL_CALLS,
              "flash_attention_hd": SDXL_BLOCKS * SDXL_CALLS + 1},
    "all": {"int8_matmul": (SDXL_DENSE_MATMULS + 11) * SDXL_CALLS
            + 2 * SDXL_BLOCKS,
            "int8_ff_geglu": SDXL_BLOCKS * SDXL_CALLS,
            "int8_conv3x3": 35 * SDXL_CALLS,
            "flash_attention_qkv_packed_int8": SDXL_BLOCKS * SDXL_CALLS,
            "flash_attention_hd": SDXL_BLOCKS * SDXL_CALLS + 1},
    "edit": {"flash_attention_hd": SDXL_SITES_PER_CALL * 2 * SDXL_NFE + 2},
}
# Phase 10: SDXL-Lightning (sdxl_lightning: SDXL's UNet, its weights
# distilled) at 1024^2, the reference's Lightning command: ddim_cfg++_lightning
# at 4 NFE, w=1 (trailing timesteps), through a full-width single file,
# convert_checkpoint and from_pretrained.  Per request: 4 UNet calls of 140
# attention sites and the decode, 561 flash_attention_hd (the 2M form loops
# timesteps[:-1]: 3 calls, 421); under --quant dense phase 9's split per
# call times 4, plus the cross k/v.  ddim_lightning and euler_lightning are
# CFG forms, so at w=1 they run the conditional branch alone: their UNet
# calls have batch 1 (the CFG++ forms batch 2).
# tests/test_torch_port_lightning_sites.py derives these from the JAX plans
# and _needs_branches.
LIGHTNING_MODEL = "sdxl_lightning"
LIGHTNING_NFE = 4
LIGHTNING_SOLVER = "ddim_cfg++_lightning"
LIGHTNING_GUIDANCE = 1.0
LIGHTNING_SOLVERS = ("ddim_lightning", "euler_lightning",
                     "euler_cfg++_lightning", "dpm++_2m_cfgpp_lightning")
# UNet calls and the batch of each call, per request
LIGHTNING_CALLS = {LIGHTNING_SOLVER: 4, "ddim_lightning": 4,
                   "euler_lightning": 4, "euler_cfg++_lightning": 4,
                   "dpm++_2m_cfgpp_lightning": LIGHTNING_NFE - 1}
LIGHTNING_BATCH = {LIGHTNING_SOLVER: 2, "ddim_lightning": 1,
                   "euler_lightning": 1, "euler_cfg++_lightning": 2,
                   "dpm++_2m_cfgpp_lightning": 2}
LIGHTNING_LAUNCHES_PER_REQUEST = {
    **{name: {"flash_attention_hd": SDXL_SITES_PER_CALL * calls + 1}
       for name, calls in LIGHTNING_CALLS.items()},
    "dense": {"int8_matmul": SDXL_DENSE_MATMULS * LIGHTNING_CALLS[
        LIGHTNING_SOLVER] + 2 * SDXL_BLOCKS,
              "int8_ff_geglu": SDXL_BLOCKS * LIGHTNING_CALLS[LIGHTNING_SOLVER],
              "flash_attention_qkv_packed": SDXL_BLOCKS * LIGHTNING_CALLS[
                  LIGHTNING_SOLVER],
              "flash_attention_hd": SDXL_BLOCKS * LIGHTNING_CALLS[
                  LIGHTNING_SOLVER] + 1},
}
# Phase 10 writes a bf16 SGM file (about 6.9 GB) and an HF-layout
# directory (about 8.8 GB: the VAE and both CLIPs in f32) into one
# temporary directory.
LIGHTNING_DISK_BYTES = 17 * 10**9

# The same kernels at SDXL's 1024^2 shapes: (level, tokens per image,
# channels, heads, transformer blocks, transformers).  Calls per request as
# for sd21_v: exact for the bf16 attention, dense for the packed and int8
# rows, all for the conv and the int8 score, the edit's encode for the f32
# attention.
SDXL_LEVELS = [("L1", 4096, 640, 10, 10, 5), ("L2", 1024, 1280, 20, 60, 6)]


def sdxl_cases(calls: int, batch: int = 2, tag: str = "sdxl"):
    """The attention, packed, int8_matmul and int8_ff_geglu rows of an SDXL
    request of ``calls`` UNet calls of batch ``batch`` (the cross k/v once
    a request, the decode's attention once)."""
    attention = [
        case for lvl, n, c, h, blocks, _ in SDXL_LEVELS for case in (
            (f"{tag} {lvl} self", (batch, n, c), n, h, None, blocks * calls),
            (f"{tag} {lvl} cross", (batch, n, c), 77, h, None,
             blocks * calls))
    ] + [(f"{tag} vae mid self", (1, 16384, 512), 16384, 1, None, 1)]
    packed = [(f"{tag} {lvl} self packed", (batch, n, 3 * c), h,
               blocks * calls) for lvl, n, c, h, blocks, _ in SDXL_LEVELS]
    matmul = [
        case for lvl, n, c, _, blocks, trs in SDXL_LEVELS for case in (
            (f"{tag} {lvl} to_qkv", (batch, n, c), 3 * c, "ln",
             blocks * calls),
            (f"{tag} {lvl} to_q", (batch, n, c), c, "ln", blocks * calls),
            (f"{tag} {lvl} attn1/attn2 to_out, proj_out", (batch, n, c), c,
             "bias_res", (2 * blocks + trs) * calls),
            (f"{tag} {lvl} proj_in (GroupNorm as the affine prologue)",
             (batch, n, c), c, "affine", trs * calls))
    ] + [(f"{tag} {lvl} cross k/v", (batch, 77, 2048), c, "none", 2 * blocks)
         for lvl, _, c, _, blocks, _ in SDXL_LEVELS]
    ff = [(f"{tag} {lvl} ff", (batch, n, c), blocks * calls)
          for lvl, n, c, _, blocks, _ in SDXL_LEVELS]
    return attention, packed, matmul, ff


(SDXL_ATTENTION_CASES, SDXL_PACKED_CASES, SDXL_INT8_MATMUL_CASES,
 SDXL_INT8_FF_CASES) = sdxl_cases(SDXL_CALLS)
SDXL_F32_ATTENTION_CASES = [
    ("sdxl vae mid self (the edit's f32 encode)", (1, 16384, 512), 16384, 1,
     None, 1)]
# (site, x shape NHWC, O, GroupNorm prologue, residual, br, calls per UNet
# call) of the 35 admitted 3x3 convs: resnet conv1 (prologue), conv2
# (prologue and the skip add as its residual) and the upsamplers.
SDXL_CONV_SITES = [
    ("down_blocks.0 resnets conv1", (2, 128, 128, 320), 320, True, False, 8, 2),
    ("down_blocks.0 / up_blocks.2 resnets conv2", (2, 128, 128, 320), 320,
     True, True, 8, 5),
    ("up_blocks.1 upsampler", (2, 128, 128, 640), 640, False, False, 4, 1),
    ("up_blocks.2 resnets.1-2 conv1", (2, 128, 128, 640), 320, True, False, 4,
     2),
    ("up_blocks.2 resnets.0 conv1", (2, 128, 128, 960), 320, True, False, 4,
     1),
    ("down_blocks.1 resnets.1 conv1", (2, 64, 64, 640), 640, True, False, 8,
     1),
    ("down_blocks.1 / up_blocks.1 resnets conv2", (2, 64, 64, 640), 640, True,
     True, 8, 5),
    ("up_blocks.1 resnets.2 conv1", (2, 64, 64, 960), 640, True, False, 8, 1),
    ("up_blocks.1 resnets.1 conv1", (2, 64, 64, 1280), 640, True, False, 8,
     1),
    ("up_blocks.0 upsampler", (2, 64, 64, 1280), 1280, False, False, 8, 1),
    ("up_blocks.1 resnets.0 conv1", (2, 64, 64, 1920), 640, True, False, 8,
     1),
    ("down_blocks.2 resnets.0 conv1", (2, 32, 32, 640), 1280, True, False, 32,
     1),
    ("down_blocks.2 resnets.1 / mid conv1", (2, 32, 32, 1280), 1280, True,
     False, 16, 3),
    ("down_blocks.2 / mid / up_blocks.0 resnets conv2", (2, 32, 32, 1280),
     1280, True, True, 16, 7),
    ("up_blocks.0 resnets.2 conv1", (2, 32, 32, 1920), 1280, True, False, 8,
     1),
    ("up_blocks.0 resnets.0-1 conv1", (2, 32, 32, 2560), 1280, True, False, 8,
     2),
]
SDXL_CONV_CASES = [(f"sdxl {site}", shape, o, gn, res, br, n * SDXL_CALLS)
                   for site, shape, o, gn, res, br, n in SDXL_CONV_SITES]
SDXL_INT8_ATTENTION_CASES = [
    (f"sdxl {lvl} self packed", (2, n, 3 * c), h, True, blocks * SDXL_CALLS)
    for lvl, n, c, h, blocks, _ in SDXL_LEVELS]
# Phase 10's rows.  The batch-2 forms (ddim_cfg++_lightning, its --quant
# dense request) run phase 9's shapes, 4 UNet calls a request: their
# per-request sums reuse the sdxl rows' times at these calls (site ->
# calls per request, by kernel).  ddim_lightning and euler_lightning run
# batch-1 UNet calls, new to the attention kernel at 1024^2: the L1 and L2
# self- and cross-attention at batch 1 are rows of their own, with the
# calls of one such request (the decode's row is the sdxl one).
LIGHTNING_SITE_CALLS = {
    name: {site: case[-1] for site, *case in cases}
    for name, cases in zip(("flash_attention_hd", "flash_attention_qkv_packed",
                            "int8_matmul", "int8_ff_geglu"),
                           sdxl_cases(LIGHTNING_CALLS[LIGHTNING_SOLVER]))}
LIGHTNING_B1_ATTENTION_CASES = sdxl_cases(
    LIGHTNING_CALLS["ddim_lightning"], batch=1,
    tag="sdxl_lightning batch 1")[0][:-1]
# Phase 11: MS-COCO eval generation, the README's command (README.md:61-63)
# through cli/text_to_mscoco.py on sdxl at 1024^2: ddim_cfg++ at lambda=0.6,
# 50 NFE, --batch_size 8, so every UNet call is batch 16 (the uncond and
# cond halves of 8 prompts); 10 prompts make two batches, the second
# padded from 2 to 8.
MSCOCO_SOLVER = "ddim_cfg++"
MSCOCO_GUIDANCE = 0.6
MSCOCO_NFE = 50
MSCOCO_BATCH = 8
MSCOCO_PROMPTS = (
    "a man riding a wave on top of a surfboard",
    "a plate of food with broccoli and rice",
    "a red double decker bus driving down a street",
    "two giraffes standing next to each other in a field",
    "a cat sitting on a laptop keyboard",
    "a kitchen with wooden cabinets and a white stove",
    "a group of people flying kites on a beach",
    "a train traveling down tracks next to a forest",
    "a bowl of fruit on a table near a window",
    "a small airplane parked on a runway at dusk",
)
# flash_attention_hd per batch: 140 sites a UNet call, one d=512 decode
# attention per image (padded slots are decoded too).
MSCOCO_LAUNCHES_PER_BATCH = MSCOCO_NFE * SDXL_SITES_PER_CALL + MSCOCO_BATCH
# --callbacks draw_tweedie draw_noisy at --callback_frequency 10 fire at
# steps 0, 9, ..., 49; each firing decodes one image per callback.
CALLBACK_FREQUENCY = 10
CALLBACK_STEPS = tuple(i for i in range(MSCOCO_NFE)
                       if i == 0 or (i + 1) % CALLBACK_FREQUENCY == 0)
CALLBACK_LAUNCHES = (MSCOCO_NFE * SDXL_SITES_PER_CALL + 1
                     + 2 * len(CALLBACK_STEPS))
# An image drawn at batch 8 against the same index drawn alone (or by
# another rank): cuDNN's convs and cuBLAS's GEMMs may pick other algorithms
# at another batch, so a whole request is held by phase 3's UNet bound.
INVARIANCE_REL_L2_TOL = MODEL_REL_L2_TOL
# Phase 12: the metric CLI on phase 11's images, full-width towers with
# seeded random weights in the published layouts.  Card against the port on
# the CPU for the same files, TF32 off on both: f32 convs and GEMMs in
# another order, so features within rel-L2 METRIC_REL_L2_TOL and FIDs
# within METRIC_FID_REL_TOL relative; the FID of a set against itself
# within SELF_FID_TRACE_SHARE x (tr S1 + tr S2) of 0 (numpy's FID of 10
# random 2048-d features against themselves read 5.9e-8 of the trace).  The
# CLI's own FIDs against those from the CPU's features of the same files
# within METRIC_FID_REL_TOL, its CLIP-score and LPIPS within
# METRIC_REL_L2_TOL relative.
METRIC_REL_L2_TOL = 1e-4
METRIC_FID_REL_TOL = 1e-3
SELF_FID_TRACE_SHARE = 1e-6
LABEL_NOISE = 8                  # paired labels: each image + U{-8..8}
LPIPS_CPU_PAIRS = 2              # pairs whose LPIPS is also run on the CPU
JPEG_FIXTURES = ROOT / "tests" / "data" / "jpeg"
# batch of each tower in the rate measurements (the functions' defaults)
METRIC_BATCH = {"inception": 50, "clip_image": 64, "clip_text": 256,
                "lpips": 8}
TEN_K = 10_000                   # images of the projected MS-COCO FID
# Phase 2's rows at UNet batch 16: sums per batch of 8 images (50 UNet
# calls, 8 decodes).
MSCOCO_B16_ATTENTION_CASES = sdxl_cases(
    MSCOCO_NFE, batch=2 * MSCOCO_BATCH, tag="sdxl mscoco b16")[0][:-1] + [
    ("sdxl mscoco b16 vae mid self (one per image)", (1, 16384, 512), 16384,
     1, None, MSCOCO_BATCH)]
# Each kind of phase-2 row: (model, its cases) in table order.
CASES = {
    "attention": (("sd15", ATTENTION_CASES), ("sd21_v", SD2_ATTENTION_CASES),
                  ("sdxl", SDXL_ATTENTION_CASES),
                  ("sdxl_lightning_b1", LIGHTNING_B1_ATTENTION_CASES),
                  ("sdxl_mscoco_b16", MSCOCO_B16_ATTENTION_CASES)),
    "attention_f32": (("sd15", ATTENTION_CASES),
                      ("sd21_v", SD2_F32_ATTENTION_CASES),
                      ("sdxl", SDXL_F32_ATTENTION_CASES)),
    "packed": (("sd15", PACKED_CASES), ("sd21_v", SD2_PACKED_CASES),
               ("sdxl", SDXL_PACKED_CASES)),
    "int8_matmul": (("sd15", INT8_MATMUL_CASES),
                    ("sd21_v", SD2_INT8_MATMUL_CASES),
                    ("sdxl", SDXL_INT8_MATMUL_CASES)),
    "int8_ff": (("sd15", INT8_FF_CASES), ("sd21_v", SD2_INT8_FF_CASES),
                ("sdxl", SDXL_INT8_FF_CASES)),
    "conv": (("sd15", CONV_CASES), ("sd21_v", SD2_CONV_CASES),
             ("sdxl", SDXL_CONV_CASES)),
    "int8_attention": (("sd15", INT8_ATTENTION_CASES),
                       ("sd21_v", SD2_INT8_ATTENTION_CASES),
                       ("sdxl", SDXL_INT8_ATTENTION_CASES)),
}

def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_name_and_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def descendants(root: int) -> list:
    """The pids of every live process below ``root``, read from /proc."""
    parent = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                stat = Path(f"/proc/{entry}/stat").read_text()
            except OSError:             # it ended while the list was read
                continue
            parent[int(entry)] = int(stat.rsplit(")", 1)[1].split()[1])
    found, level = [], {root}
    while level:
        level = {pid for pid, ppid in parent.items() if ppid in level}
        found += sorted(level)
    return found


def stop_child_processes() -> list:
    """Stops the processes this run started that would outlive it and
    returns what it had to end beyond them.  A JPEG `AsyncImageReader`
    (phase 12) leaves multiprocessing's forkserver and resource tracker
    running after its pool has shut down; each exits only once it reads
    the end of its pipe from this process, some time after this process
    has gone.  Both are stopped and waited for here (the semaphores of the
    pools are released first, or releasing them at exit would start the
    tracker again); any other process still below this one is killed."""
    from multiprocessing import forkserver, resource_tracker

    gc.collect()
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    left = []
    for pid in descendants(os.getpid()):
        try:
            left.append(Path(f"/proc/{pid}/cmdline").read_bytes()
                        .replace(b"\0", b" ").decode(errors="replace")[:120])
            os.kill(pid, signal.SIGKILL)
        except OSError:         # it ended on its own
            continue
    for _ in left:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(-1, 0)
    return left


# Device-side spin before each timed run (about 25 ms at the H100's clocks):
# the host queues the timed calls behind it, so a call shorter than its own
# enqueue (a wrapper takes 20-30 us of host time) is timed on the device and
# not at the host's enqueue rate.
SPIN_CYCLES = 50_000_000


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time per call over ``reps`` calls, after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def beyond_one_ulp(got: torch.Tensor, want: torch.Tensor,
                   mantissa_bits: int = 7, atol: float = 0.0) -> float:
    """Share of the elements of ``got`` more than one ulp (bf16: 7
    mantissa bits, f32: 23) plus ``atol`` of ``want`` from it."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -100)))
                     - mantissa_bits)
    return ((got - want).abs() > ulp + atol).float().mean().item()


def build_all(build) -> None:
    """One nvcc per CUDA source, all started together."""
    names = build.LIBRARIES
    with ThreadPoolExecutor(len(names)) as pool:
        results = list(pool.map(build.build_library, names))
    for name, res in zip(names, results):
        usage = [ln.strip() for ln in res.log.splitlines() if "registers" in ln]
        print(f"  built {res.path.name} in {res.seconds:.2f} s; "
              f"{'; '.join(usage) or 'already built'}", flush=True)
    for name in names:
        build.load_library(name)


def sdpa_backend(fn) -> str:
    """The backend that served one ``scaled_dot_product_attention`` call,
    read from the names of the device kernels it launched."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        return "unknown: no device kernels in the trace"
    low = " ".join(names).lower()
    for backend, keys in (("cudnn", ("cudnn",)),
                          ("flash", ("flash",)),
                          ("efficient", ("fmha", "cutlassf", "mem_eff"))):
        if any(key in low for key in keys):
            return backend
    return "math: " + ", ".join(sorted(set(n[:40] for n in names)))


H100_SMS = 132


def flash_blocks(batch: int, n: int, heads: int, rows_per_warp: int = 32):
    """(blocks, warps per block) that ``csrc/flash_attention.cu``'s
    ``launch_rows`` picks at head dim 64 (two 16-row m tiles a warp): four
    warps a block where that grid covers every SM, else one."""
    blocks4 = -(-n // (4 * rows_per_warp)) * heads * batch
    if blocks4 >= H100_SMS:
        return blocks4, 4
    return -(-n // rows_per_warp) * heads * batch, 1


def sdpa_heads(x, heads: int, rows: int):
    """[B, N, H*D] -> the head-split view [B, H, rows, D] (no copy)."""
    b, n, hd = x.shape
    return x.view(b, n, heads, hd // heads)[:, :rows].transpose(1, 2)


class KernelTable:
    """Per-kernel rows of phase 2: error against the plain version, both
    times per call, the work's bound on the card and, where one PyTorch call
    computes the same function, that call's time at each shape."""

    def __init__(self, card: str):
        self.card = card
        self.rows = {}

    def measure(self, kernel_name, site, desc, kernel, ref, plain, calls,
                work, rule="rel", library=None, others=None,
                bf16_values=False, flipped_rows=None, model="sd15"):
        """``model``: the model whose path makes these calls (its requests'
        sums are kept apart).  ``rule``: "rel", "f32", "exact" or "ulp"
        (see the tolerances above); ``bf16_values``: the (f32) output must
        hold bf16 values;
        ``flipped_rows``: bool [rows] of the rows whose int8 input the
        LayerNorm flipped, left out of the "ulp" share.
        ``work``: the `roofline.Work` of one call.  ``library``: the one
        PyTorch call that computes the same function, timed beside the
        kernel (never used by the port).  ``others``: {name: fn} of further
        routes to time beside them (e.g. ``int8_product_cublaslt``: the bare
        int8 products of the int8 rows on ``torch._int_mm``, a yardstick for
        the GEMM core, not the function's library time)."""
        out = kernel()
        torch.cuda.synchronize()
        want = ref()
        err = (out.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        bits = 23 if rule == "f32" else 7
        off = beyond_one_ulp(out, want, bits)
        if flipped_rows is not None:
            keep, rows = ~flipped_rows, flipped_rows.numel()
            off = beyond_one_ulp(out.reshape(rows, -1)[keep],
                                 want.reshape(rows, -1)[keep], bits)
        ok = bool(torch.isfinite(out).all())
        if bf16_values:
            ok = ok and torch.equal(out, out.bfloat16().float())
        if rule == "exact":
            ok, tol = ok and err == 0.0, "tol: exact"
        elif rule == "ulp":
            ok = ok and off <= ULP_SHARE and err <= KERNEL_REL_TOL * scale
            tol = (f"beyond one bf16 ulp {off:.2e} of elements, tol"
                   f" {ULP_SHARE}; max tol {KERNEL_REL_TOL} x {scale:.3e}")
            if flipped_rows is not None:
                tol += (f"; {int(flipped_rows.sum())} rows with an"
                        " LN-flipped int8 value left out")
        else:
            rel = F32_REL_TOL if rule == "f32" else KERNEL_REL_TOL
            ok, tol = ok and err <= rel * scale, f"tol {rel} x {scale:.3e}"
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        bound_ms = work.bound_ms()
        extra = {f"{name}_ms": time_ms(fn) for name, fn in (others or {}).items()}
        shown = "".join(f" {k[:-3]} {v:.4f} ms" for k, v in extra.items())
        library_ms = backend = None
        if library is not None:
            library_ms, backend = time_ms(library), sdpa_backend(library)
            shown += f" library {library_ms:.4f} ms ({backend})"
        if bf16_values:
            tol += "; output holds bf16 values"
        print(f"  {kernel_name} {site}: {desc}: max_abs_err {err:.3e} ({tol})"
              f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms{shown} bound"
              f" {bound_ms:.5f} ms by {work.bound_by()}, {bound_ms / ms:.1%}"
              f" of it [{self.card}]", flush=True)
        check(ok, f"{kernel_name} disagrees with its plain version at {site}")
        self.rows.setdefault(kernel_name, []).append(
            {"model": model, "site": site, "shape": desc,
             "calls_per_request": calls,
             "rule": rule, "max_abs_err": err, "beyond_one_ulp": off,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": work.bound_by(), "share_of_bound": bound_ms / ms,
             "library_ms": library_ms, "library_backend": backend, **extra})

    def summary(self, kernel_name, derived=None) -> dict:
        """Per request of the SD-1.5 path: the sum over its shapes of calls
        x time per call; ``by_model``: the same for each model's path.
        ``derived``: {path: (model, {site: calls per request})}, a path that
        runs ``model``'s shapes at other calls per request (its sums reuse
        those rows' times)."""
        rows = self.rows[kernel_name]

        def per_request(model_rows, calls):
            n = {r["site"]: calls[r["site"]] if calls else
                 r["calls_per_request"] for r in model_rows}
            top = max(model_rows, key=lambda r: (
                n[r["site"]] * r["bound_ms"], r["bound_ms"]))
            library = all(r["library_ms"] is not None for r in model_rows)
            out = {key: sum(n[r["site"]] * r[key] for r in model_rows)
                   for key in ("ms", "plain_ms", "bound_ms")}
            out.update(bound_by=top["bound_by"], library_ms=sum(
                n[r["site"]] * r["library_ms"] for r in model_rows)
                if library else None)
            return out

        by_model = {m: per_request([r for r in rows if r["model"] == m], None)
                    for m in dict.fromkeys(r["model"] for r in rows)}
        for path, (model, calls) in (derived or {}).items():
            by_model[path] = per_request(
                [r for r in rows if r["model"] == model], calls)
        return {"max_abs_err": max(r["max_abs_err"] for r in rows),
                **by_model["sd15"], "by_model": by_model, "shapes": rows}


def compare_rows(site, xq, sx, want_xq, want_sx, ln: bool) -> str:
    """The kernel's quantized rows (or conv windows) against the plain
    quantizer's: bit for bit without a prologue (LayerNorm, GroupNorm +
    SiLU), else within LN_FLIP_SHARE / SX_REL_TOL."""
    d = (xq.float() - want_xq.float()).abs()
    flips, level = (d > 0).float().mean().item(), d.max().item()
    sx_rel = ((sx - want_sx).abs() / want_sx).max().item()
    if ln:
        check(flips <= LN_FLIP_SHARE and level <= 1 and sx_rel <= SX_REL_TOL,
              f"{site}: int8 rows differ from quantize_rows (LayerNorm)")
    else:
        check(flips == 0 and sx_rel == 0,
              f"{site}: int8 rows differ from quantize_rows")
    return (f"int8 rows: {flips:.2e} flipped (max {level:.0f} level), scales"
            f" rel {sx_rel:.2e}")


def check_bf16_write(site, out, unrounded) -> str:
    """``out``: an f32 output that holds bf16 values; ``unrounded``: the
    plain version's f32 value before its bf16 write.  Each element of
    ``out`` must be the bf16 rounding of a value within F32_REL_TOL x
    max |unrounded| of ``unrounded``: equal to ``bf16(unrounded)`` except
    near a rounding tie."""
    out, u = out.float(), unrounded.float()
    slack = F32_REL_TOL * u.abs().max().item()
    ok = (out >= (u - slack).bfloat16().float()) \
        & (out <= (u + slack).bfloat16().float())
    ties = (out != u.bfloat16().float()).float().mean().item()
    check(bool(ok.all()), f"{site}: {int((~ok).sum())} of {ok.numel()}"
          " elements are no bf16 rounding of a value within"
          f" {F32_REL_TOL} x max of the unrounded plain value")
    return (f"bf16 write of the unrounded f32 value (tol {F32_REL_TOL} x"
            f" {u.abs().max().item():.3e}): {ties:.2e} of elements at a tie")


def flipped_rows(tk, x, xq, kw):
    """bool [rows]: the rows where the kernel's int8 input (xq [rows, K])
    differs from `quantize_rows` of the plain LayerNorm."""
    want = tk.quantize_rows(tk.prologue_reference(
        x, kw["ln_scale"], kw["ln_bias"]))[0].reshape(xq.shape)
    return (xq.float() != want).any(dim=-1)


def check_matmul_stages(tk, site, x, wq, ws, kw) -> None:
    """int8_matmul: the kernel's int8 rows and row scales against
    `quantize_rows`, and its output against the plain GEMM and epilogue run
    from those rows (exactly)."""
    out, xq, sx = tk.int8_matmul_stages(x, wq, ws, **kw)
    pro = {k: v for k, v in kw.items() if k.startswith(("ln_", "affine_"))}
    want_xq, want_sx = tk.quantize_rows(tk.prologue_reference(x, **pro))
    rows = compare_rows(site, xq, sx, want_xq, want_sx, "ln_scale" in kw)
    epi = tk.dequant_reference(xq, sx, wq, ws, kw.get("bias"),
                               kw.get("residual")).bfloat16().to(out.dtype)
    epi_err = (out.float() - epi.float()).abs().max().item()
    print(f"    stages: {rows}; GEMM + epilogue from them max_abs_err"
          f" {epi_err:.3e} (tol: exact)", flush=True)
    check(epi_err == 0.0, f"{site}: GEMM/epilogue differs from the plain one")


def check_ff_stages(tk, site, args, kw) -> None:
    """int8_ff_geglu: input rows as `check_matmul_stages`; the f32 hidden
    state against `geglu_hidden_reference` from the kernel's rows; its
    requantize against `quantize_rows` of the kernel's own f32 hidden state
    (bit for bit: quantized from f32, over all N); the output against the
    plain second GEMM and epilogue from the kernel's hidden rows (exactly)."""
    x, w1q, w1s, b1, w2q, w2s, b2 = args
    out, xq, sx, h, hq, sh = tk.int8_ff_geglu_stages(*args, **kw)
    want_xq, want_sx = tk.quantize_rows(tk.prologue_reference(
        x, kw["ln_scale"], kw["ln_bias"]))
    rows = compare_rows(site, xq, sx, want_xq, want_sx, True)
    want_h = tk.geglu_hidden_reference(xq, sx, w1q, w1s, b1)
    h_err = (h - want_h).abs().max().item()
    check(h_err == 0.0, f"{site}: f32 hidden state differs")
    want_hq, want_sh = tk.quantize_rows(h)
    hflips = (hq.float() != want_hq).float().mean().item()
    check(hflips == 0 and torch.equal(sh, want_sh),
          f"{site}: hidden requantize differs from quantize_rows of f32 h")
    epi = tk.dequant_reference(hq, sh, w2q, w2s, b2,
                               kw.get("residual")).bfloat16().to(out.dtype)
    epi_err = (out.float() - epi.float()).abs().max().item()
    print(f"    stages: {rows}; f32 hidden max_abs_err {h_err:.3e} (tol:"
          f" exact); hidden requantize {hflips:.2e} flipped (tol:"
          f" exact); second GEMM + epilogue max_abs_err {epi_err:.3e} (tol:"
          f" exact)", flush=True)
    check(epi_err == 0.0, f"{site}: second GEMM/epilogue differs")


def check_conv_stages(tc, site, x, wq, ws, kw) -> None:
    """int8_conv3x3: the kernel's int8 windows and window scales against
    `conv_windows_reference` (bit for bit without the prologue), and its
    output against the plain GEMM and epilogue run from those windows
    (exactly)."""
    out, xq, sx = tc.int8_conv3x3_stages(x, wq, ws, **kw)
    want_xq, want_sx = tc.conv_windows_reference(
        tc.conv_prologue_reference(x, kw.get("gn_scale"), kw.get("gn_bias")),
        kw["block_rows"])
    rows = compare_rows(site, xq, sx, want_xq, want_sx, "gn_scale" in kw)
    epi = tc.window_conv_reference(xq, sx, wq, ws, kw.get("bias"),
                                   kw.get("residual"), x.shape[0]).bfloat16(
                                   ).to(out.dtype)
    epi_err = (out.float() - epi.float()).abs().max().item()
    print(f"    stages: {rows}; GEMM + epilogue from them max_abs_err"
          f" {epi_err:.3e} (tol: exact)", flush=True)
    check(epi_err == 0.0, f"{site}: conv GEMM/epilogue differs from the plain"
          " one")


def check_int8_score_stages(fa, site, q, k, stages) -> None:
    """Int8-score attention: the kernel's int8 q and k and both scales
    against `quantize_qk_reference`, bit for bit."""
    _, qq, sq, kq, sk = stages
    want = fa.quantize_qk_reference(q, k, sq.shape[-1])
    same = [torch.equal(got.float(), w.float())
            for got, w in zip((qq, sq, kq, sk), want)]
    print(f"    stages: int8 q, q scales, int8 k, k scales equal to"
          f" quantize_qk_reference: {same} (tol: exact)", flush=True)
    check(all(same), f"{site}: int8 q/k or scales differ from the plain ones")


def check_batch_invariance(fa, randn) -> None:
    """The batch-16 attention sites: the grid the kernel picks, and rows
    0-1 and 14-15 of a batch-16 call bit for bit a batch-2 call on the
    same rows (a block handles one (batch row, head, q tile), so a row's
    output does not depend on the batch around it)."""
    for site, (b, n, c), nkv, heads, _, _ in MSCOCO_B16_ATTENTION_CASES[:-1]:
        blocks, warps = flash_blocks(b, n, heads)
        q, k, v = (randn(*shape).bfloat16()
                   for shape in ((b, n, c), (b, nkv, c), (b, nkv, c)))
        out = fa.flash_attention_hd(q, k, v, heads)
        same = [torch.equal(out[r:r + 2], fa.flash_attention_hd(
            q[r:r + 2], k[r:r + 2], v[r:r + 2], heads)) for r in (0, b - 2)]
        print(f"  flash_attention_hd {site}: grid of {blocks} blocks of"
              f" {warps} warp(s) ({-(-n // (4 * 32 if warps == 4 else 32))}"
              f" x {heads} x {b}); rows 0-1 and {b - 2}-{b - 1} bit for bit"
              f" the batch-2 call's: {same}", flush=True)
        check(all(same), f"{site}: a row's attention depends on the batch")


def model_cases(kind: str):
    """(model, *case) of every phase-2 case of ``kind``, in table order."""
    return [(model, *case) for model, cases in CASES[kind] for case in cases]


def phase_kernels(fa, tk, tc, rl, quantize_kernel_int8,
                  quantize_conv_kernel_int8, table: KernelTable) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for model, cases in CASES["attention"]:
        for site, (b, n, c), nkv, heads, kv_len, calls in cases:
            q, k, v = (randn(*shape).bfloat16()
                       for shape in ((b, n, c), (b, nkv, c), (b, nkv, c)))
            rows = nkv if kv_len is None else kv_len
            qh, kh, vh = (sdpa_heads(x, heads, r)
                          for x, r in ((q, n), (k, rows), (v, rows)))
            table.measure(
                "flash_attention_hd", site,
                f"q {[b, n, c]} kv {nkv} heads {heads} d {c // heads} kv_len"
                f" {kv_len}",
                lambda: fa.flash_attention_hd(q, k, v, heads, kv_len=kv_len),
                lambda: fa.flash_attention_hd_reference(
                    q.float(), k.float(), v.float(), heads, kv_len=kv_len),
                lambda: fa.flash_attention_hd_reference(q, k, v, heads,
                                                        kv_len=kv_len),
                calls, rl.flash_attention(b, n, rows, heads, c // heads),
                library=lambda: F.scaled_dot_product_attention(qh, kh, vh),
                model=model)

    for site, (b, n, c), _, heads, _, _ in LIGHTNING_B1_ATTENTION_CASES:
        blocks, warps = flash_blocks(b, n, heads)
        print(f"  flash_attention_hd {site}: grid of {blocks} blocks of"
              f" {warps} warp(s) (csrc/flash_attention.cu launch_rows: four"
              f" warps where that gives every one of {H100_SMS} SMs a block)",
              flush=True)
    check_batch_invariance(fa, randn)
    torch.cuda.empty_cache()     # the batch-16 plain versions' f32 scores

    for model, cases in CASES["packed"]:
        for site, shape, heads, calls in cases:
            qkv = randn(*shape).bfloat16()
            b, n, c3 = shape
            qh, kh, vh = (sdpa_heads(x, heads, n)
                          for x in qkv.split(c3 // 3, dim=2))
            table.measure(
                "flash_attention_qkv_packed", site,
                f"qkv {list(shape)} heads {heads} d {c3 // 3 // heads}",
                lambda: fa.flash_attention_qkv_packed(qkv, heads),
                lambda: fa.flash_attention_qkv_packed_reference(qkv.float(),
                                                                heads),
                lambda: fa.flash_attention_qkv_packed_reference(qkv, heads),
                calls, rl.flash_attention(b, n, n, heads, c3 // 3 // heads),
                library=lambda: F.scaled_dot_product_attention(qh, kh, vh),
                model=model)

    for model, cases in CASES["attention_f32"]:
        for site, (b, n, c), nkv, heads, kv_len, calls in cases:
            q, k, v = (randn(*shape)
                       for shape in ((b, n, c), (b, nkv, c), (b, nkv, c)))
            rows = nkv if kv_len is None else kv_len
            qh, kh, vh = (sdpa_heads(x, heads, r)
                          for x, r in ((q, n), (k, rows), (v, rows)))
            table.measure(
                "flash_attention_hd_f32", site,
                f"q {[b, n, c]} f32 kv {nkv} heads {heads} d {c // heads}"
                f" kv_len {kv_len}",
                lambda: fa.flash_attention_hd(q, k, v, heads, kv_len=kv_len),
                lambda: fa.flash_attention_hd_reference(q, k, v, heads,
                                                        kv_len=kv_len),
                lambda: fa.flash_attention_hd_reference(q, k, v, heads,
                                                        kv_len=kv_len),
                calls, rl.flash_attention_f32(b, n, rows, heads, c // heads),
                rule="f32",
                library=lambda: F.scaled_dot_product_attention(qh, kh, vh),
                model=model)

    for site, shape, heads, calls in PACKED_CASES:   # f32 --quant dense's
        qkv = randn(*shape)
        b, n, c3 = shape
        qh, kh, vh = (sdpa_heads(x, heads, n)
                      for x in qkv.split(c3 // 3, dim=2))
        table.measure(
            "flash_attention_qkv_packed_f32", site,
            f"qkv {list(shape)} f32 heads {heads} d {c3 // 3 // heads}",
            lambda: fa.flash_attention_qkv_packed(qkv, heads),
            lambda: fa.flash_attention_qkv_packed_reference(qkv, heads),
            lambda: fa.flash_attention_qkv_packed_reference(qkv, heads), calls,
            rl.flash_attention_f32(b, n, n, heads, c3 // 3 // heads),
            rule="f32",
            library=lambda: F.scaled_dot_product_attention(qh, kh, vh))

    # Each int8 entry point in bf16, then in f32 (its "_f32" table rows).
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        int8_kernel_rows(fa, tk, tc, rl, quantize_kernel_int8,
                         quantize_conv_kernel_int8, table, randn, dt, sfx)


def int8_kernel_rows(fa, tk, tc, rl, quantize_kernel_int8,
                     quantize_conv_kernel_int8, table, randn, dt, sfx) -> None:
    """Phase 2's rows of the int8 kernels with activations of dtype ``dt``
    (bf16, or f32 under the kernel names + ``sfx``).  The ``torch._int_mm``
    and bf16 dequantized-conv yardsticks are timed beside the bf16 rows
    only: they do not depend on the activations' dtype."""
    bf16 = dt == torch.bfloat16
    act = rl.BF16 if bf16 else rl.F32
    out = {} if bf16 else {"out_dtype": dt}

    def weights(k, n):
        wq, ws = quantize_kernel_int8(randn(n, k, scale=k ** -0.5))
        return wq, ws, randn(n, scale=0.1)

    for model, site, (b, t, k), n, mode, calls in model_cases("int8_matmul"):
        x = randn(b, t, k).to(dt)
        wq, ws, bias = weights(k, n)
        kw = dict(out)
        if mode == "ln":
            kw.update(ln_scale=1.0 + randn(k, scale=0.1),
                      ln_bias=randn(k, scale=0.1))
        elif mode in ("bias_res", "bias"):
            kw["bias"] = bias
            if mode == "bias_res":
                kw["residual"] = randn(b, t, n).to(dt)
        elif mode == "affine":
            kw.update(affine_scale=randn(b, k), affine_bias=randn(b, k),
                      bias=bias)
        work = rl.int8_matmul(b * t, k, n, ln=mode == "ln",
                              bias="bias" in kw, residual="residual" in kw,
                              affine=b if mode == "affine" else 0, act=act)
        xq = tk.int8_matmul_stages(x, wq, ws, **kw)[1].reshape(-1, k)
        flipped = flipped_rows(tk, x, xq, kw) if mode == "ln" else None
        table.measure(
            "int8_matmul" + sfx, site, f"x {[b, t, k]} {dt} N {n} {mode}",
            lambda: tk.int8_matmul(x, wq, ws, **kw),
            lambda: tk.int8_matmul_reference(x, wq, ws, **kw),
            lambda: tk.int8_matmul_reference(x, wq, ws, **kw), calls, work,
            rule="ulp" if mode == "ln" else "exact", bf16_values=not bf16,
            flipped_rows=flipped, model=model,
            others={"int8_product_cublaslt": lambda: torch._int_mm(
                xq, wq.t())} if bf16 else None)
        check_matmul_stages(tk, site, x, wq, ws, kw)

    for model, site, (b, t, c), calls in model_cases("int8_ff"):
        x = randn(b, t, c).to(dt)
        w1q, w1s, b1 = weights(c, 8 * c)
        w2q, w2s, b2 = weights(4 * c, c)
        kw = dict(out, ln_scale=1.0 + randn(c, scale=0.1),
                  ln_bias=randn(c, scale=0.1),
                  residual=randn(b, t, c).to(dt))
        args = (x, w1q, w1s, b1, w2q, w2s, b2)
        _, xq, _, _, hq, _ = tk.int8_ff_geglu_stages(*args, **kw)
        xq, hq = xq.reshape(-1, c), hq.reshape(-1, 4 * c)
        flipped = flipped_rows(tk, x, xq, kw)
        table.measure(
            "int8_ff_geglu" + sfx, site,
            f"x {[b, t, c]} {dt} N {4 * c} O {c} ln res",
            lambda: tk.int8_ff_geglu(*args, **kw),
            lambda: tk.int8_ff_geglu_reference(*args, **kw),
            lambda: tk.int8_ff_geglu_reference(*args, **kw), calls,
            rl.int8_ff_geglu(b * t, c, act=act),
            rule="ulp", bf16_values=not bf16, flipped_rows=flipped,
            model=model, others={"int8_product_cublaslt": lambda: (
                torch._int_mm(xq, w1q.t()), torch._int_mm(hq, w2q.t()))}
            if bf16 else None)
        check_ff_stages(tk, site, args, kw)

    for model, site, (b, h, w, c), o, gn, res, br, calls in model_cases(
            "conv"):
        check(not calls or (tc.scale_window_rows(h, w, c, o) == br
                            and tc.int8_conv3x3_supported((b, h, w, c),
                                                          (1, 1), 1, o)),
              f"int8_conv3x3 {site}: not a kernel site with br {br}")
        x = randn(b, h, w, c).to(dt)
        wq, ws = quantize_conv_kernel_int8(randn(o, c, 3, 3,
                                                 scale=(9 * c) ** -0.5))
        kw = dict(out, bias=randn(o, scale=0.1), block_rows=br)
        if gn:
            kw.update(gn_scale=1.0 + randn(b, c, scale=0.2),
                      gn_bias=randn(b, c, scale=0.3))
        if res:
            kw["residual"] = randn(b, h, w, o).to(dt)
        wf = (wq.float() * ws[:, None, None, None]).bfloat16().permute(
            0, 3, 1, 2)
        xc = x.permute(0, 3, 1, 2)
        table.measure(
            "int8_conv3x3" + sfx, site,
            f"x {[b, h, w, c]} {dt} O {o} br {br}{' gn' if gn else ''}"
            f"{' res' if res else ''}",
            lambda: tc.int8_conv3x3(x, wq, ws, **kw),
            lambda: tc.int8_conv3x3_reference(x, wq, ws, **kw),
            lambda: tc.int8_conv3x3_reference(x, wq, ws, **kw), calls,
            rl.int8_conv3x3(b, h, w, c, o, groupnorm=gn, residual=res,
                            act=act),
            rule="ulp" if gn else "exact", bf16_values=not bf16, model=model,
            others={"bf16_dequant_conv": lambda: torch.nn.functional.conv2d(
                xc, wf, padding=1)} if bf16 else None)
        check_conv_stages(tc, site, x, wq, ws, kw)

    # The int8-score attention, bf16 and f32, by "ulp" and as a bf16 write of
    # the plain version's unrounded f32 value (p bit-equal on both sides,
    # rounded to bf16 or not; the output rounded to bf16 on both sides).
    for model, site, shape, heads, packed, calls in model_cases(
            "int8_attention"):
        if packed:
            qkv = randn(*shape).to(dt)
            q, k, v = qkv.split(shape[2] // 3, dim=2)
            name = "flash_attention_qkv_packed_int8"
            run = (lambda: fa.flash_attention_qkv_packed_int8(qkv, heads))
            ref = (lambda: fa.flash_attention_qkv_packed_int8_reference(
                qkv, heads, out_dtype=torch.float32))
            plain = (lambda: fa.flash_attention_qkv_packed_int8_reference(
                qkv, heads))
            exact = (lambda: fa.flash_attention_qkv_packed(qkv, heads))
            stages = fa.flash_attention_qkv_packed_int8_stages(qkv, heads)
            d = shape[2] // 3 // heads
        else:
            q, k, v = (randn(*shape).to(dt) for _ in range(3))
            name = "flash_attention_hd_int8"
            run = (lambda: fa.flash_attention_hd_int8(q, k, v, heads))
            ref = (lambda: fa.flash_attention_hd_int8_reference(
                q, k, v, heads, out_dtype=torch.float32))
            plain = (lambda: fa.flash_attention_hd_int8_reference(q, k, v,
                                                                  heads))
            exact = (lambda: fa.flash_attention_hd(q, k, v, heads))
            stages = fa.flash_attention_hd_int8_stages(q, k, v, heads)
            d = shape[2] // heads
        table.measure(name + sfx, site,
                      f"{list(shape)} {dt} heads {heads} d {d}", run, ref,
                      plain, calls,
                      rl.flash_attention_int8(shape[0], shape[1], shape[1],
                                              heads, d, act=act),
                      rule="ulp", bf16_values=not bf16, model=model,
                      others={("bf16" if bf16 else "f32") + "_kernel": exact})
        print(f"  {name + sfx} {site}: " + check_bf16_write(
            site, run(), fa.int8_score_attention_f32(
                q, k, v, heads, shape[1])), flush=True)
        check_int8_score_stages(fa, site, q, k, stages)
    check_int8_score_domain(fa, randn, dt)


# Outside the int8 score's domain the JAX int8-score functions run the bf16
# kernel, and so do the port's: the packed entry point at a token count that
# is no multiple of 128, the unpacked one at more kv rows than one TPU block
# holds.
# (site, q or packed qkv shape, kv rows of the unpacked entry point, heads)
INT8_DOMAIN_EDGE_CASES = [
    ("packed, 1000 tokens", (2, 1000, 3 * 640), None, 8),
    ("hd, 4200 kv rows", (2, 256, 320), 4200, 8),
]


def check_int8_score_domain(fa, randn, dt) -> None:
    """Each case equals the flash-attention kernel's output exactly, and
    only the flash-attention counters move."""
    for site, shape, nkv, heads in INT8_DOMAIN_EDGE_CASES:
        if nkv is None:
            qkv = randn(*shape).to(dt)
            run = lambda: fa.flash_attention_qkv_packed_int8(qkv, heads)  # noqa: E731
            want = fa.flash_attention_qkv_packed(qkv, heads)
            moved = "packed_launches"
        else:
            b, n, c = shape
            q, k, v = (randn(b, rows, c).to(dt) for rows in (n, nkv, nkv))
            run = lambda: fa.flash_attention_hd_int8(q, k, v, heads)  # noqa: E731
            want = fa.flash_attention_hd(q, k, v, heads)
            moved = "launches"
        names = ("launches", "packed_launches", "int8_launches",
                 "packed_int8_launches")
        before = {n: getattr(fa, n) for n in names}
        out = run()
        torch.cuda.synchronize()
        delta = {n: getattr(fa, n) - before[n] for n in names}
        same = torch.equal(out, want)
        print(f"  int8-score attention outside its domain, {site} {dt}: equal"
              f" to the flash kernel {same} (tol: exact); launches {delta}",
              flush=True)
        check(same, f"int8-score attention {site} {dt}: differs from the"
              " flash kernel outside the int8 domain")
        check(delta == {n: int(n == moved) for n in names},
              f"int8-score attention {site} {dt}: launches {delta}")


def conditioning(engine, prompts, resolution=RESOLUTION):
    """(context, added) of a batch of prompts: added is () for the SD
    family, SDXL's (pooled text embeds, time ids at the default micro-
    conditioning) otherwise; a UNet call takes ``unet(z, t, ctx, *added)``."""
    ctx, pooled = engine.text_embed(prompts)
    if pooled is None:
        return ctx, ()
    size = (resolution, resolution)
    ids = engine.make_add_time_ids(len(prompts), size, (0, 0), size)
    return ctx, (pooled, torch.as_tensor(ids, device="cuda"))


def unet_inputs(engine, resolution=RESOLUTION):
    """(z, ctx, t, added) of one batch-2B UNet call."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    s = resolution // engine.bundle.vae_scale_factor
    z = torch.randn((2, s, s, 4), generator=gen, device="cuda")
    ctx, added = conditioning(engine, ["", PROMPTS[0]], resolution)
    return z, ctx, torch.tensor(501, device="cuda"), added


def phase_models_vs_plain_attention(engine, fa,
                                    resolution=RESOLUTION) -> None:
    """One UNet call (batch 2B = 2 at the slice's latent) and one VAE decode,
    each with the kernel and with the plain attention in its place."""
    from cfgpp_tpu_torch.models import attention
    from cfgpp_tpu_torch.models.unet import precompute_cross_kv

    unet, vae = engine.bundle.unet, engine.bundle.vae
    z, ctx, t, added = unet_inputs(engine, resolution)

    def run():
        with torch.inference_mode():
            eps = unet(z, t, ctx, *added,
                       cross_kv=precompute_cross_kv(unet, ctx))
            img = vae.decode(z[:1] * 3.0)
        return eps, img

    eps_k, img_k = run()
    with mock.patch.object(attention, "flash_attention_hd",
                           fa.flash_attention_hd_reference):
        eps_p, img_p = run()
    for what, got, want in (("unet eps", eps_k, eps_p), ("vae decode", img_k, img_p)):
        err = rel_l2(got, want)
        print(f"  {what}: kernel vs plain attention rel_l2 {err:.3e}"
              f" (tol {MODEL_REL_L2_TOL})", flush=True)
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        check(err <= MODEL_REL_L2_TOL, f"{what}: kernel path disagrees")


def phase_f32(fa, tk, tc, card: str) -> dict:
    """An f32 bundle: the VAE encode of a 512^2 image and one UNet call at
    512^2 (batch 2B = 2), each with the f32 kernel (its launches counted
    from 0) and with the plain attention in its place; then one f32 UNet
    call with ``--quant dense`` and one with ``--quant all``, each with the
    kernels (every count set to 0 just before it) against the same modules
    with every kernel's plain version.  Returns the launches of the f32
    path under the f32 kernels' names."""
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
    from cfgpp_tpu_torch.models import attention
    from cfgpp_tpu_torch.models.unet import precompute_cross_kv

    bundle = ModelBundle.random_init("sd15", seed=0, dtype=torch.float32,
                                     device="cuda")
    engine = DiffusionEngine(bundle, "ddim_cfg++", nfe=NFE)
    unet, vae = bundle.unet, bundle.vae
    z, ctx, t, _ = unet_inputs(engine)
    check(z.dtype == ctx.dtype == torch.float32, "f32 bundle: inputs not f32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    img = torch.rand((1, RESOLUTION, RESOLUTION, 3), generator=gen,
                     device="cuda") * 2.0 - 1.0
    runs = {"vae encode": lambda: torch.cat(vae.encode(img), dim=-1),
            "unet eps": lambda: unet(z, t, ctx,
                                     cross_kv=precompute_cross_kv(unet, ctx))}
    launches = 0
    for what, run in runs.items():
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            got = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = fa.launches
        with mock.patch.object(attention, "flash_attention_hd",
                               fa.flash_attention_hd_reference), \
                torch.inference_mode():
            want = run()
        err = rel_l2(got, want)
        print(f"  f32 {what}: {tuple(got.shape)} {got.dtype} in {seconds:.3f}"
              f" s, {n} f32 kernel launches; kernel vs plain attention rel_l2"
              f" {err:.3e} (tol {F32_MODEL_REL_L2_TOL}) [{card}]", flush=True)
        check(got.dtype == torch.float32
              and bool(torch.isfinite(got).all()), f"f32 {what}: output")
        check(n == F32_LAUNCHES[what], f"f32 {what}: {n} launches, expected"
              f" {F32_LAUNCHES[what]}")
        check(err <= F32_MODEL_REL_L2_TOL, f"f32 {what}: kernel path disagrees")
        launches += n
        # the same call under the CLIs' default, cuDNN TF32 on (a
        # measurement: the bound above holds the TF32-off path)
        torch.backends.cudnn.allow_tf32 = True
        with torch.inference_mode():
            got_tf32 = run()
        torch.backends.cudnn.allow_tf32 = False
        err = rel_l2(got_tf32, want)
        print(f"  f32 {what} with cuDNN TF32 on (the CLIs' default): kernel"
              f" vs plain attention (TF32 off) rel_l2 {err:.3e},"
              f" {'inside' if err <= F32_MODEL_REL_L2_TOL else 'outside'}"
              f" the {F32_MODEL_REL_L2_TOL} bound [{card}]", flush=True)
    out = {"flash_attention_hd_f32": launches,
           "flash_attention_qkv_packed_f32": fa.packed_launches}

    reads = counters(fa, tk, tc)
    for mode, tol in (("dense", INT8_MODEL_REL_L2_TOL),
                      ("all", INT8_ALL_MODEL_REL_L2_TOL)):
        unet_q = bundle.quantized(mode).unet

        def run():
            with torch.inference_mode():
                return unet_q(z, t, ctx,
                              cross_kv=precompute_cross_kv(unet_q, ctx))

        for mod in (fa, tk, tc):
            mod.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {name: read() for name, read in reads.items()}
        with plain_kernels(fa, tk, tc):
            want = run()
        err = rel_l2(got, want)
        expected = {name: F32_INT8_LAUNCHES_PER_CALL[mode].get(name, 0)
                    for name in reads}
        print(f"  f32 --quant {mode} unet eps: {tuple(got.shape)} {got.dtype}"
              f" in {seconds:.3f} s, launches {counts}; kernels vs plain"
              f" versions rel_l2 {err:.3e} (tol {tol}) [{card}]", flush=True)
        check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
              f"f32 --quant {mode} unet eps: output")
        check(counts == expected, f"f32 --quant {mode}: launches {counts},"
              f" expected {expected}")
        check(err <= tol, f"f32 --quant {mode} unet eps: kernel path"
              " disagrees")
        for name, n in counts.items():
            out[name + "_f32"] = out.get(name + "_f32", 0) + n
        del unet_q
        torch.cuda.empty_cache()
    return out


def plain_kernels(fa, tk, tc):
    """Every kernel wrapper of the UNet's modules patched to its plain
    version."""
    from contextlib import ExitStack

    from cfgpp_tpu_torch.models import attention, quant
    from cfgpp_tpu_torch.models import unet as unet_mod

    stack = ExitStack()
    for mod, name, ref in (
            (quant, "int8_matmul", tk.int8_matmul_reference),
            (quant, "int8_conv3x3", tc.int8_conv3x3_reference),
            (unet_mod, "int8_ff_geglu", tk.int8_ff_geglu_reference),
            (attention, "flash_attention_qkv_packed",
             fa.flash_attention_qkv_packed_reference),
            (attention, "flash_attention_qkv_packed_int8",
             fa.flash_attention_qkv_packed_int8_reference),
            (attention, "flash_attention_hd", fa.flash_attention_hd_reference)):
        stack.enter_context(mock.patch.object(mod, name, ref))
    return stack


def phase_int8_unet_vs_plain(engine_q, fa, tk, tc, label: str,
                             tol: float, resolution=RESOLUTION) -> None:
    """One quantized UNet call with the kernels against the same modules with
    every kernel's plain version in its place."""
    from cfgpp_tpu_torch.models import unet as unet_mod

    unet = engine_q.bundle.unet
    z, ctx, t, added = unet_inputs(engine_q, resolution)

    def run():
        with torch.inference_mode():
            return unet(z, t, ctx, *added,
                        cross_kv=unet_mod.precompute_cross_kv(unet, ctx))

    eps_k = run()
    with plain_kernels(fa, tk, tc):
        eps_p = run()
    err = rel_l2(eps_k, eps_p)
    print(f"  {label} unet eps: kernels vs plain versions rel_l2 {err:.3e}"
          f" (tol {tol})", flush=True)
    check(bool(torch.isfinite(eps_k).all()),
          f"{label} unet eps: non-finite output")
    check(err <= tol, f"{label} unet eps: kernel path disagrees")


def check_image(img, label: str, resolution: int) -> None:
    check(img.dtype == torch.float32
          and tuple(img.shape) == (1, resolution, resolution, 3),
          f"{label}: image {tuple(img.shape)} {img.dtype}")
    check(bool(torch.isfinite(img).all()), f"{label}: non-finite image")
    check(img.min().item() >= 0.0 and img.max().item() <= 1.0,
          f"{label}: image outside [0, 1]")


def one_request(engine, prompt, counters, label: str,
                resolution: int = RESOLUTION, guidance: float = GUIDANCE,
                **kw):
    """One request of batch 1 through ``DiffusionEngine.sample``; returns
    (image, trajectory or None, seconds, launches of each counter).
    ``prompt``: the conditional prompt, or the list [null, src, tgt] of an
    edit request."""
    before = {name: read() for name, read in counters.items()}
    prompts = prompt if isinstance(prompt, list) else ["", prompt]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.sample(prompts, cfg_guidance=guidance, seed=SEED,
                        resolution=resolution, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    img, traj = out if kw.get("return_trajectory") else (out, None)
    check_image(img, label, resolution)
    return img, traj, seconds, {name: read() - before[name]
                                for name, read in counters.items()}


def run_requests(engine, counters, card: str, label: str,
                 resolution: int = RESOLUTION, guidance: float = GUIDANCE):
    """Three requests of batch 1; returns the launches of each counter per
    request and the trajectory of the first.  ``counters``: {kernel name:
    () -> current count}."""
    images, seconds, counts, trajs = [], [], [], []
    for i, prompt in enumerate((PROMPTS[0], PROMPTS[1], PROMPTS[0])):
        img, traj, sec, n = one_request(engine, prompt, counters, label,
                                        resolution, guidance,
                                        return_trajectory=i == 0)
        seconds.append(sec)
        counts.append(n)
        trajs.append(traj)
        images.append(engine._to_uint8(img).int())
    for i, (sec, n) in enumerate(zip(seconds, counts), 1):
        print(f"  {label} request {i}: {sec:.3f} s/image, launches {n}"
              f" [{card}]", flush=True)
    check(bool((images[0] != images[1]).any()),
          f"{label}: images 1 and 2 are identical")
    diff = (images[2] - images[0]).abs().max().item()
    check(diff <= 1, f"{label}: image 3 differs from image 1 by {diff} levels")
    print(f"  {label}: images 1/2 differ; image 3 within {diff} level(s) of"
          f" image 1; peak device memory"
          f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return counts, trajs[0]


def counters(fa, tk, tc):
    return {"flash_attention_hd": lambda: fa.launches,
            "flash_attention_qkv_packed": lambda: fa.packed_launches,
            "flash_attention_hd_int8": lambda: fa.int8_launches,
            "flash_attention_qkv_packed_int8": lambda: fa.packed_int8_launches,
            "int8_matmul": lambda: tk.matmul_launches,
            "int8_ff_geglu": lambda: tk.ff_launches,
            "int8_conv3x3": lambda: tc.conv_launches}


def phase_slice_requests(engine, fa, tk, tc, card: str, label: str,
                         expected: dict, resolution: int = RESOLUTION,
                         guidance: float = GUIDANCE):
    """Three requests with every count set to 0 just before them; checks the
    launches of each request and returns the counts of the whole run and
    the first request's trajectory."""
    reads = counters(fa, tk, tc)
    want = {name: expected.get(name, 0) for name in reads}
    torch.cuda.reset_peak_memory_stats()
    for mod in (fa, tk, tc):
        mod.reset_launches()
    counts, traj = run_requests(engine, reads, card, label, resolution,
                                guidance)
    check(all(n == want for n in counts),
          f"{label}: launches per request {counts}, expected {want}")
    return {name: read() for name, read in reads.items()}, traj


def quant_drift(traj_e, traj_q, label: str) -> float:
    """The quant-drift gate of ``python -m cfgpp_tpu_torch.cli.parity_check
    --quant_drift`` (`parity_check.drift_summary`, the JAX CLI's rule) on
    the trajectories a phase already has: per-step MAE of the int8
    trajectory against the exact one from the same zT (the same prompt and
    seed), each normalized by the exact step's mean magnitude; the worst
    must stay under 0.15."""
    from cfgpp_tpu_torch.cli.parity_check import drift_summary

    out = drift_summary(traj_e, traj_q, QUANT_DRIFT_BUDGET)
    worst = out["worst_rel_mae"]
    worst_step = max(out["per_step"],
                     key=lambda r: max(r["rel_z0t"], r["rel_zt"]))["step"]
    print(f"  {label} quant drift: worst per-step rel-MAE {worst:.4f} at step"
          f" {worst_step} (budget {QUANT_DRIFT_BUDGET})", flush=True)
    check(out["verdict"] == "WITHIN-INT8-BUDGET",
          f"{label}: quant drift {worst} over budget")
    return worst


def guidance_of(spec) -> float:
    return GUIDANCE if spec.cfgpp else 7.5


def eps_synthetic(z, t):
    """The port's solver tests' synthetic eps pair (eps_uc, eps_c)."""
    tt = t.float() * 0.001
    return 0.05 * z + torch.sin(tt), -0.03 * z + torch.cos(2.0 * tt)


def phase_solver_loops() -> float:
    """Every SD solver's loop, the inversion loop in both forms and the 5
    SDXL-Lightning loops (trailing timesteps, LIGHTNING_NFE, w=1) on CUDA
    tensors, each against the same loop on the CPU with the card's noise
    copied over; returns the worst error relative to its bound."""
    from cfgpp_tpu_torch.schedules.ddim import make_ddim_schedule
    from cfgpp_tpu_torch.solvers import plans, registry, sampler

    sched = make_ddim_schedule(NFE)
    names = sorted({registry.get_solver_spec(n).name
                    for n in registry.list_solvers("sd")})
    check(len(names) == 14, f"{len(names)} SD solvers, expected 14")
    jobs = [(registry.get_solver_spec(n), sched) for n in names]
    lightning = [registry.get_solver_spec(n, "sdxl")
                 for n in registry.list_solvers("sdxl")
                 if registry.get_solver_spec(n, "sdxl").lightning]
    check(len(lightning) == 5, f"{len(lightning)} Lightning solvers")
    trailing = make_ddim_schedule(LIGHTNING_NFE, timestep_spacing="trailing")
    jobs += [(spec, trailing) for spec in lightning]
    worst = 0.0

    def hold(what, got, want):
        nonlocal worst
        check(got.device.type == "cuda", f"loop {what}: ran on {got.device}")
        err = (got.cpu() - want).abs().max().item()
        tol = LOOP_REL_TOL * max(1.0, want.abs().max().item())
        worst = max(worst, err / tol)
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"loop {what}: card vs CPU max err {err:.3e} (tol {tol:.3e})")

    for spec, schedule in jobs:
        name, plan = spec.name, spec.plan_fn(schedule)
        w = LIGHTNING_GUIDANCE if spec.lightning else guidance_of(spec)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        zT = sampler.init_latent(plan, gen, LOOP_SHAPE)
        drawn = []

        def card_noise(i, like):
            drawn.append(torch.randn(like.shape, generator=gen,
                                     device=like.device))
            return drawn[-1]

        ancestral = plan.needs_noise
        got, (gz0, gzt) = sampler.run_solver(
            spec, plan, eps_synthetic, zT, w,
            noise_fn=card_noise if ancestral else None, return_trajectory=True)
        want, (wz0, wzt) = sampler.run_solver(
            spec, plan, eps_synthetic, zT.cpu(), w,
            noise_fn=(lambda i, like: drawn[i].cpu()) if ancestral else None,
            return_trajectory=True)
        check(len(drawn) == (plan.n_steps if ancestral else 0),
              f"loop {name}: {len(drawn)} noise draws")
        for what, g, x in (("final", got, want), ("z0t", gz0, wz0),
                           ("zt", gzt, wzt)):
            hold(f"{name} {what}", g, x)
    inv_plan = plans.plan_ddim_inversion(sched)
    z0 = torch.randn(LOOP_SHAPE, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    for name in ("ddim_inversion", "ddim_inversion_cfg++"):
        spec = registry.get_solver_spec(name)
        got = sampler.run_inversion(spec, inv_plan, eps_synthetic, z0,
                                    guidance_of(spec))
        want = sampler.run_inversion(spec, inv_plan, eps_synthetic, z0.cpu(),
                                     guidance_of(spec))
        hold(f"run_inversion {name}", got, want)
    print(f"  solver loops: {len(names)} SD solvers and run_inversion in both"
          f" forms, {NFE} NFE, and the {len(lightning)} Lightning solvers,"
          f" {LIGHTNING_NFE} NFE trailing at w={LIGHTNING_GUIDANCE}, at"
          f" {LOOP_SHAPE}: card vs CPU within tolerance (worst {worst:.3f} of"
          f" it; tol {LOOP_REL_TOL} x max(1, scale))", flush=True)
    return worst


def source_image(path: Path, resolution: int = RESOLUTION) -> np.ndarray:
    """An image of ``resolution``^2 made from the seed, written with
    save_image and read back with load_image (the inversion CLI's reader):
    [1, H, W, 3] in [-1, 1]."""
    from cfgpp_tpu_torch.utils.img import load_image, save_image, to_uint8

    low = torch.rand((1, 3, 8, 8), generator=torch.Generator().manual_seed(SEED))
    img = F.interpolate(low, size=(resolution, resolution), mode="bicubic",
                        align_corners=False).clamp(0.0, 1.0)
    img = img.permute(0, 2, 3, 1).numpy()
    save_image(img, path)
    arr = load_image(path, size=resolution, centered=True)
    check(arr.shape == (1, resolution, resolution, 3)
          and np.array_equal(arr, to_uint8(img) / np.float32(127.5) - 1.0),
          "source image: load_image does not read back what save_image wrote")
    return arr


def expected_solver_launches(spec) -> int:
    if spec.inversion:
        return SOLVER_LAUNCHES_PER_REQUEST["inversion"]
    if spec.kind == "dpm2s":
        return SOLVER_LAUNCHES_PER_REQUEST["dpm2s"]
    return SOLVER_LAUNCHES_PER_REQUEST["one call a step"]


def phase_solver_requests(bundle, fa, tk, tc, src: np.ndarray,
                          card: str) -> dict:
    """One request per new sampling solver and the five inversion requests,
    every count set to 0 just before each and read just after; returns
    {label: s/image}."""
    from cfgpp_tpu_torch.engine import DiffusionEngine

    reads = counters(fa, tk, tc)
    runs = [(name, None, ["", PROMPTS[0]], {}) for name in SAMPLING_SOLVERS]
    runs += [(name, init, ["", PROMPTS[0], PROMPTS[1]] if "edit" in name
              else ["", PROMPTS[0]], {"src_img": src, "latent_init": init})
             for name, init in INVERSION_REQUESTS]
    seconds = {}
    for name, init, prompt, kw in runs:
        engine = DiffusionEngine(bundle, name, nfe=NFE)
        label = name + (f" latent_init={init}" if init else "")
        for mod in (fa, tk, tc):
            mod.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = engine.sample(prompt, cfg_guidance=guidance_of(engine.spec),
                            seed=SEED, resolution=RESOLUTION, **kw)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        counts = {n: read() for n, read in reads.items()}
        want = {n: 0 for n in reads}
        want["flash_attention_hd"] = expected_solver_launches(engine.spec)
        print(f"  {label} (w={guidance_of(engine.spec)}):"
              f" {seconds[label]:.3f} s/image, flash_attention_hd launches"
              f" {counts['flash_attention_hd']} [{card}]", flush=True)
        check_image(img, label, RESOLUTION)
        check(counts == want, f"{label}: launches {counts}, expected {want}")
    return seconds


def phase_first_steps(bundle, fa, src: np.ndarray,
                      names=SAMPLING_SOLVERS + ("ddim_inversion",
                                                "ddim_inversion_cfg++"),
                      resolution: int = RESOLUTION, nfe: int = NFE,
                      guidance=guidance_of) -> None:
    """The first step of every new solver and of the inversion in both
    forms, with the kernel and with the plain attention in its place, from
    the same zT (or encoded latent) and noise: the eps pair of the step's
    first UNet call by phase 3's UNet bound, its guided eps_hat and the
    step's (z0t, zt) by that bound x max(1, w).  The step consumes eps_hat
    = eps_uc + w (eps_c - eps_uc), and at w > 1 the mix multiplies the
    error of the branches' difference by w: on the H100 (sd15, random
    weights, the first Karras step) each branch reads rel-L2 1.6-1.8e-2,
    eps_hat 4.2e-2 at w=7.5 and the CFG forms' z0t 3.7e-2."""
    import dataclasses

    from cfgpp_tpu_torch.engine import DiffusionEngine
    from cfgpp_tpu_torch.models import attention
    from cfgpp_tpu_torch.solvers import sampler, steps

    for name in names:
        engine = DiffusionEngine(bundle, name, nfe=nfe)
        spec, w = engine.spec, guidance(engine.spec)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        with torch.inference_mode():
            uc, added_uc = conditioning(engine, [""], resolution)
            c, added_c = conditioning(engine, [PROMPTS[0]], resolution)
            if spec.inversion:
                z = engine._encode(torch.from_numpy(src).cuda(), gen)
            else:
                z = sampler.init_latent(engine.plan, gen,
                                        engine.latent_shape(1, resolution))
            noise = torch.randn(z.shape, generator=gen, device="cuda")

        def run():
            eps_pairs = []

            def eps_fn(zz, t):
                eps_pairs.append(unet_eps(zz, t))
                return eps_pairs[-1]

            with torch.inference_mode():
                unet_eps = engine._make_eps_fn(uc, c, w, added_uc or None,
                                               added_c or None)
                if spec.inversion:
                    row = {k: torch.as_tensor(v[0], device="cuda")
                           for k, v in engine.inv_plan.coeffs.items()}
                    zt, z0t = steps.ddim_inversion_step(
                        eps_fn, torch.tensor(w, device="cuda"), row, z,
                        cfgpp=spec.cfgpp)
                else:
                    one = dataclasses.replace(engine.plan, n_steps=1)
                    _, (z0s, zts) = sampler.run_solver(
                        spec, one, eps_fn, z, w,
                        noise_fn=lambda i, like: noise,
                        return_trajectory=True)
                    z0t, zt = z0s[0], zts[0]
            eps_uc, eps_c = eps_pairs[0]
            return eps_uc, eps_c, eps_uc + w * (eps_c - eps_uc), z0t, zt

        got = run()
        with mock.patch.object(attention, "flash_attention_hd",
                               fa.flash_attention_hd_reference):
            want = run()
        errs = [rel_l2(g, x) for g, x in zip(got, want)]
        step_tol = MODEL_REL_L2_TOL * max(1.0, w)
        print(f"  {name} first step (w={w}): kernel vs plain attention rel_l2"
              f" eps_uc {errs[0]:.3e}, eps_c {errs[1]:.3e} (tol"
              f" {MODEL_REL_L2_TOL}); eps_hat {errs[2]:.3e}, z0t"
              f" {errs[3]:.3e}, zt {errs[4]:.3e} (tol {step_tol:.3g})",
              flush=True)
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{name} first step: non-finite output")
        check(max(errs[:2]) <= MODEL_REL_L2_TOL,
              f"{name} first step: the UNet's kernel path disagrees")
        check(max(errs[2:]) <= step_tol,
              f"{name} first step: the step's kernel path disagrees")


def phase_solvers(bundle, fa, tk, tc, card: str) -> dict:
    import tempfile

    t0 = time.perf_counter()
    phase_solver_loops()
    with tempfile.TemporaryDirectory() as tmp:
        src = source_image(Path(tmp) / "source.png")
    phase_first_steps(bundle, fa, src)
    seconds = phase_solver_requests(bundle, fa, tk, tc, src, card)
    print(f"  phase 7 wall time {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return seconds


def phase_sd2(fa, tk, tc, card: str):
    """sd21_v (SD-2.1 widths and depth, v-prediction) at 768^2 through
    ``DiffusionEngine.sample``: one UNet call and one VAE decode against the
    plain attention, the first ``ddim_cfg++`` step against the plain
    attention (the v -> eps boundary on the card), three exact requests,
    one ``--quant dense`` and one ``--quant all`` request (each with its
    UNet call against every kernel's plain version and its quant drift
    against the first exact request), and one ``ddim_inversion_cfg++``
    request of a 768^2 image; every count set to 0 just before each run.
    Returns (the launches of each run under "sd21_v <form>", the quant
    drift of each int8 form)."""
    import tempfile

    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle

    res, want = SD2_RESOLUTION, SD2_LAUNCHES_PER_REQUEST
    t0 = time.perf_counter()
    bundle = ModelBundle.random_init("sd21_v", seed=0, dtype=torch.bfloat16,
                                     device="cuda")
    engine = DiffusionEngine(bundle, "ddim_cfg++", nfe=NFE)
    torch.cuda.synchronize()
    cfg = bundle.config
    check(cfg.unet.prediction_type == "v_prediction"
          and cfg.unet.use_linear_projection and engine._abar is not None
          and engine._abar.device.type == "cuda", "sd21_v: not the v-"
          "prediction linear-projection bundle")
    print(f"  random sd21_v bundle on the card in"
          f" {time.perf_counter() - t0:.2f} s", flush=True)
    phase_models_vs_plain_attention(engine, fa, res)
    with tempfile.TemporaryDirectory() as tmp:
        src = source_image(Path(tmp) / "source.png", res)
    phase_first_steps(bundle, fa, src, ("ddim_cfg++",), res)

    reads = counters(fa, tk, tc)
    launches, seconds = {}, {}
    runs = {"exact": phase_slice_requests(
        engine, fa, tk, tc, card, "sd21_v exact", want["exact"], res)}
    launches["sd21_v exact"], traj_e = runs["exact"]
    drift = {}
    for mode, tol in (("dense", INT8_MODEL_REL_L2_TOL),
                      ("all", INT8_ALL_MODEL_REL_L2_TOL)):
        label = f"sd21_v --quant {mode}"
        engine_q = DiffusionEngine(bundle.quantized(mode), "ddim_cfg++",
                                   nfe=NFE)
        phase_int8_unet_vs_plain(engine_q, fa, tk, tc, label, tol, res)
        torch.cuda.reset_peak_memory_stats()
        for mod in (fa, tk, tc):
            mod.reset_launches()
        _, traj_q, seconds[mode], n = one_request(
            engine_q, PROMPTS[0], reads, label, res, return_trajectory=True)
        expect = {name: want[mode].get(name, 0) for name in reads}
        print(f"  {label}: {seconds[mode]:.3f} s/image, launches {n}; peak"
              f" device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB [{card}]", flush=True)
        check(n == expect, f"{label}: launches {n}, expected {expect}")
        launches[f"sd21_v {mode}"] = n
        drift[f"sd21_v {mode}"] = quant_drift(traj_e, traj_q, label)
        del engine_q
        torch.cuda.empty_cache()

    label = "sd21_v ddim_inversion_cfg++"
    inv = DiffusionEngine(bundle, "ddim_inversion_cfg++", nfe=NFE)
    torch.cuda.reset_peak_memory_stats()
    for mod in (fa, tk, tc):
        mod.reset_launches()
    _, _, seconds["inversion"], n = one_request(inv, PROMPTS[0], reads, label,
                                                res, src_img=src)
    expect = {name: want["inversion"].get(name, 0) for name in reads}
    print(f"  {label}: {seconds['inversion']:.3f} s/image, launches {n};"
          f" peak device memory"
          f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)
    check(n == expect, f"{label}: launches {n}, expected {expect}")
    launches["sd21_v inversion"] = n
    del inv, engine, bundle
    torch.cuda.empty_cache()
    return launches, drift


def phase_sdxl(fa, tk, tc, card: str):
    """SDXL (stabilityai/stable-diffusion-xl-base-1.0 widths and depth: the
    dual CLIP, the text_time added embedding, 10-block transformer stacks)
    at 1024^2 through ``DiffusionEngine.sample``, ``dpm++_2m_cfgpp`` at
    w=5, 25 NFE: one UNet call and one VAE decode against the plain
    attention, the first step against the plain attention, three exact
    requests, one ``--quant dense`` and one ``--quant all`` request (each
    with its UNet call against every kernel's plain version and its quant
    drift against the first exact request), and one ``ddim_edit_cfg++``
    request of a 1024^2 image; every count set to 0 just before each run.
    Returns (the launches of each run under "sdxl <form>", the quant drift
    of each int8 form, {form: s/image})."""
    import tempfile

    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle

    res, want, w = SDXL_RESOLUTION, SDXL_LAUNCHES_PER_REQUEST, SDXL_GUIDANCE
    t0 = time.perf_counter()
    bundle = ModelBundle.random_init("sdxl", seed=0, dtype=torch.bfloat16,
                                     device="cuda")
    engine = DiffusionEngine(bundle, SDXL_SOLVER, nfe=SDXL_NFE)
    torch.cuda.synchronize()
    check(bundle.family == "sdxl" and bundle.text_encoder_2 is not None
          and engine.plan.n_steps == SDXL_CALLS
          and len(list(bundle.unet.cross_attention_sites())) ==
          SDXL_TRANSFORMERS, "sdxl: not the SDXL bundle and plan")
    print(f"  random sdxl bundle on the card in {time.perf_counter() - t0:.2f}"
          f" s; {SDXL_SOLVER} at {SDXL_NFE} NFE: {SDXL_CALLS} UNet calls a"
          " request", flush=True)
    phase_models_vs_plain_attention(engine, fa, res)
    with tempfile.TemporaryDirectory() as tmp:
        src = source_image(Path(tmp) / "source.png", res)
    phase_first_steps(bundle, fa, src, (SDXL_SOLVER,), res, SDXL_NFE,
                      lambda spec: w)

    reads = counters(fa, tk, tc)
    launches, seconds, drift = {}, {}, {}
    launches["sdxl exact"], traj_e = phase_slice_requests(
        engine, fa, tk, tc, card, "sdxl exact", want["exact"], res, w)
    for mode, tol in (("dense", INT8_MODEL_REL_L2_TOL),
                      ("all", INT8_ALL_MODEL_REL_L2_TOL)):
        label = f"sdxl --quant {mode}"
        engine_q = DiffusionEngine(bundle.quantized(mode), SDXL_SOLVER,
                                   nfe=SDXL_NFE)
        phase_int8_unet_vs_plain(engine_q, fa, tk, tc, label, tol, res)
        torch.cuda.reset_peak_memory_stats()
        for mod in (fa, tk, tc):
            mod.reset_launches()
        _, traj_q, seconds[mode], n = one_request(
            engine_q, PROMPTS[0], reads, label, res, w,
            return_trajectory=True)
        expect = {name: want[mode].get(name, 0) for name in reads}
        print(f"  {label}: {seconds[mode]:.3f} s/image, launches {n}; peak"
              f" device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB [{card}]", flush=True)
        check(n == expect, f"{label}: launches {n}, expected {expect}")
        launches[f"sdxl {mode}"] = n
        drift[f"sdxl {mode}"] = quant_drift(traj_e, traj_q, label)
        del engine_q
        torch.cuda.empty_cache()

    label = f"sdxl {SDXL_EDIT_SOLVER}"
    edit = DiffusionEngine(bundle, SDXL_EDIT_SOLVER, nfe=SDXL_NFE)
    torch.cuda.reset_peak_memory_stats()
    for mod in (fa, tk, tc):
        mod.reset_launches()
    _, _, seconds["edit"], n = one_request(
        edit, ["", PROMPTS[0], PROMPTS[1]], reads, label, res,
        SDXL_EDIT_GUIDANCE, src_img=src)
    expect = {name: want["edit"].get(name, 0) for name in reads}
    print(f"  {label} (lambda={SDXL_EDIT_GUIDANCE}): {seconds['edit']:.3f}"
          f" s/image, launches {n}; peak device memory"
          f" {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)
    check(n == expect, f"{label}: launches {n}, expected {expect}")
    launches["sdxl edit"] = n
    del edit, engine, bundle
    torch.cuda.empty_cache()
    return launches, drift, seconds


def bundle_tensors(bundle) -> dict:
    """{module.name: tensor} of every module of a bundle."""
    return {f"{attr}.{k}": v for attr in ("unet", "vae", "text_encoder",
                                          "text_encoder_2")
            for k, v in getattr(bundle, attr).state_dict().items()}


def check_bit_equal(got, want, what: str) -> None:
    got, want = bundle_tensors(got), bundle_tensors(want)
    bad = [k for k in want if k not in got or got[k].dtype != want[k].dtype
           or not torch.equal(got[k], want[k])]
    check(sorted(got) == sorted(want) and not bad,
          f"{what}: {len(bad)} tensors differ from the random bundle's"
          f" (first {bad[:3]})")


def timed(fn):
    """(fn's result, its seconds), the device synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_lightning(fa, tk, tc, card: str):
    """SDXL-Lightning at 1024^2 from files, through the user's entry points:
    a seeded random ``sdxl_lightning`` bundle on the card (bf16; its f32
    VAE and CLIPs rounded to bf16 values, so that a bf16 file holds them
    exactly) written as a full SGM single file by the port's inverse map;
    ``cli.convert_checkpoint`` of that file to the native (HF) layout;
    ``from_pretrained`` of it, bit for bit the random bundle; then the
    engine from ``cli.common.build_engine`` of the reference's command
    (``--ckpt_dir`` and ``--light_ckpt`` over it), bit for bit again.  Runs
    the first ``ddim_cfg++_lightning`` step and the first (batch-1)
    ``ddim_lightning`` step against the plain attention, three exact
    requests, one ``--quant dense`` request (UNet call against every
    kernel's plain version, drift against the first exact request), one
    request of each other Lightning solver (the batch of each UNet call
    checked), and the w=5 refusal before any UNet call; every count set to 0
    just before each run.  Returns (the launches of each run under
    "sdxl_lightning <form>", the dense drift, {form: s/image})."""
    import argparse
    import shutil
    import tempfile

    from cfgpp_tpu_torch.cli import common, convert_checkpoint
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
    from cfgpp_tpu_torch.tools.sgm_synth import synth_single_file
    from cfgpp_tpu_torch.weights.safetensors_io import save_file

    res, want, w = SDXL_RESOLUTION, LIGHTNING_LAUNCHES_PER_REQUEST, \
        LIGHTNING_GUIDANCE
    tmp_root = tempfile.gettempdir()
    free = shutil.disk_usage(tmp_root).free
    print(f"  {tmp_root}: {free / 1e9:.1f} GB free, phase 10 needs"
          f" {LIGHTNING_DISK_BYTES / 1e9:.0f} GB", flush=True)
    check(free >= LIGHTNING_DISK_BYTES, f"{tmp_root} has {free / 1e9:.1f} GB"
          f" free; phase 10 writes about {LIGHTNING_DISK_BYTES / 1e9:.0f} GB"
          " (set TMPDIR to a larger disk)")
    rand = ModelBundle.random_init(LIGHTNING_MODEL, seed=0,
                                   dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        for p in bundle_tensors(rand).values():
            p.copy_(p.bfloat16())
    seconds, launches = {}, {}
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        single, native = Path(tmp) / "sdxl_lightning.safetensors", \
            Path(tmp) / "native"
        state = {k: v.bfloat16() for k, v in synth_single_file(rand).items()}
        nbytes, sec = timed(lambda: save_file(state, single))
        del state
        print(f"  wrote the SGM single file: {nbytes / 1e9:.3f} GB in"
              f" {sec:.2f} s, {nbytes / 1e9 / sec:.2f} GB/s [{card}]",
              flush=True)
        _, sec = timed(lambda: convert_checkpoint.main([
            "--model", LIGHTNING_MODEL, "--single_file", str(single),
            "--dst", str(native), "--dtype", "bfloat16", "--device",
            "cuda"]))
        nat = dir_bytes(native)
        print(f"  convert_checkpoint --single_file: read {nbytes / 1e9:.3f} GB,"
              f" wrote {nat / 1e9:.3f} GB in {sec:.2f} s,"
              f" {(nbytes + nat) / 1e9 / sec:.2f} GB/s [{card}]", flush=True)
        loaded, sec = timed(lambda: ModelBundle.from_pretrained(
            native, LIGHTNING_MODEL, dtype=torch.bfloat16, device="cuda"))
        print(f"  from_pretrained: {nat / 1e9:.3f} GB in {sec:.2f} s,"
              f" {nat / 1e9 / sec:.2f} GB/s [{card}]", flush=True)
        check_bit_equal(loaded, rand, "from_pretrained")
        del loaded
        parser = argparse.ArgumentParser()
        common.add_common_args(parser)
        args = common.parse_args(parser, [
            "--model", LIGHTNING_MODEL, "--ckpt_dir", str(native),
            "--light_ckpt", str(single), "--method", LIGHTNING_SOLVER,
            "--NFE", str(LIGHTNING_NFE), "--cfg_guidance", "1"])
        engine, sec = timed(lambda: common.build_engine(args))
        print(f"  build_engine --ckpt_dir --light_ckpt: read"
              f" {(nat + nbytes) / 1e9:.3f} GB in {sec:.2f} s,"
              f" {(nat + nbytes) / 1e9 / sec:.2f} GB/s [{card}]", flush=True)
        check(args.cfg_guidance == w and args.device == "cuda"
              and engine.solver_name == LIGHTNING_SOLVER
              and engine.nfe == LIGHTNING_NFE, "build_engine: not the"
              " reference's Lightning command")
        check_bit_equal(engine.bundle, rand, "build_engine")
    del rand
    torch.cuda.empty_cache()
    bundle = engine.bundle

    phase_first_steps(bundle, fa, None, (LIGHTNING_SOLVER, "ddim_lightning"),
                      res, LIGHTNING_NFE, lambda spec: w)

    reads = counters(fa, tk, tc)
    label = f"{LIGHTNING_MODEL} exact"
    launches[label], traj_e = phase_slice_requests(
        engine, fa, tk, tc, card, label, want[LIGHTNING_SOLVER], res, w)

    label = f"{LIGHTNING_MODEL} --quant dense"
    engine_q = DiffusionEngine(bundle.quantized("dense"), LIGHTNING_SOLVER,
                               nfe=LIGHTNING_NFE)
    phase_int8_unet_vs_plain(engine_q, fa, tk, tc, label,
                             INT8_MODEL_REL_L2_TOL, res)
    torch.cuda.reset_peak_memory_stats()
    for mod in (fa, tk, tc):
        mod.reset_launches()
    _, traj_q, seconds["dense"], n = one_request(
        engine_q, PROMPTS[0], reads, label, res, w, return_trajectory=True)
    expect = {name: want["dense"].get(name, 0) for name in reads}
    print(f"  {label}: {seconds['dense']:.3f} s/image, launches {n}; peak"
          f" device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB [{card}]", flush=True)
    check(n == expect, f"{label}: launches {n}, expected {expect}")
    launches[f"{LIGHTNING_MODEL} dense"] = n
    drift = quant_drift(traj_e, traj_q, label)
    del engine_q
    torch.cuda.empty_cache()

    for name in LIGHTNING_SOLVERS:
        other = DiffusionEngine(bundle, name, nfe=LIGHTNING_NFE)
        batches = []
        hook = bundle.unet.register_forward_pre_hook(
            lambda module, a: batches.append(a[0].shape[0]))
        torch.cuda.reset_peak_memory_stats()
        for mod in (fa, tk, tc):
            mod.reset_launches()
        try:
            _, _, seconds[name], n = one_request(other, PROMPTS[0], reads,
                                                 name, res, w)
        finally:
            hook.remove()
        expect = {k: want[name].get(k, 0) for k in reads}
        calls = [LIGHTNING_BATCH[name]] * LIGHTNING_CALLS[name]
        print(f"  {LIGHTNING_MODEL} {name}: {seconds[name]:.3f} s/image,"
              f" launches {n}, UNet calls of batch {batches}; peak device"
              f" memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
              f" [{card}]", flush=True)
        check(n == expect, f"{name}: launches {n}, expected {expect}")
        check(batches == calls, f"{name}: UNet calls of batch {batches},"
              f" expected {calls}")
        launches[f"{LIGHTNING_MODEL} {name}"] = n

    for mod in (fa, tk, tc):
        mod.reset_launches()
    try:
        engine.sample(["", PROMPTS[0]], cfg_guidance=5.0, seed=SEED,
                      resolution=res)
        refused = None
    except ValueError as e:
        refused = str(e)
    n = {name: read() for name, read in reads.items()}
    print(f"  {LIGHTNING_SOLVER} at w=5: refused ({refused!r}); launches {n}",
          flush=True)
    check(refused == "CFG should be turned off (cfg_guidance=1) in the"
          " lightning version", f"w=5 not refused as the JAX engine does:"
          f" {refused!r}")
    check(not any(n.values()), f"w=5: kernels launched before the refusal {n}")
    del engine, bundle
    torch.cuda.empty_cache()
    return launches, drift, seconds


def phase_mscoco(fa, tk, tc, card: str, tmp: Path) -> dict:
    """MS-COCO eval generation through the CLIs on one sdxl bundle (random
    weights from seed 0, bf16), every count set to 0 just before each run:
    the README's command through ``text_to_mscoco.main`` on 10 prompts at
    ``--batch_size 8`` (two batches, the second padded); its ``--resume``
    after one image is deleted; index 9 drawn alone by ``sample_batch``
    against the batch-8 image; two ranks (``RANK``/``WORLD_SIZE`` 0/2, then
    1/2) each writing its one image; ``text_to_img.main`` with
    ``--callbacks draw_tweedie draw_noisy --callback_frequency 10``, then
    the same request with and without callbacks, fused and unrolled, and a
    callback that halves zt at step 0 in both modes.  The CLIs' engines
    share the first one's bundle.  Everything is written under ``tmp``;
    ``tmp / "coco"`` keeps the README command's ten images for phase 12.
    Returns the launches of each run."""
    from cfgpp_tpu_torch.cli import common, text_to_img, text_to_mscoco
    from cfgpp_tpu_torch.engine import ComposeCallback, DiffusionEngine
    from cfgpp_tpu_torch.utils.img import (load_image, normalize, read_png,
                                           to_uint8)

    started = time.perf_counter()
    reads = counters(fa, tk, tc)
    res, made, starts = SDXL_RESOLUTION, {}, []

    def build_engine(args):
        """``cli.common.build_engine``, its bundle made once."""
        dev = torch.device(args.device)
        key = (args.model, args.dtype, torch.device(dev.type, dev.index or 0),
               args.ckpt_dir, args.light_ckpt, args.quant)
        check(key == ("sdxl", "bfloat16", torch.device("cuda", 0), None, None,
                      None), f"phase 11: bundle arguments {key}")
        if "bundle" not in made:
            engine, made["seconds"] = timed(lambda: common.build_engine(args))
            made["bundle"] = engine.bundle
            return engine
        return DiffusionEngine(made["bundle"], args.method, nfe=args.NFE)

    sample_batch = DiffusionEngine.sample_batch

    def timed_batch(self, *a, **kw):
        starts.append(time.perf_counter())
        return sample_batch(self, *a, **kw)

    def launches():
        return {name: read() for name, read in reads.items()}

    def expect(n_hd: int) -> dict:
        return {name: n_hd if name == "flash_attention_hd" else 0
                for name in reads}

    def mscoco(workdir: Path, *extra: str, env=None):
        """One ``text_to_mscoco.main`` run; returns (launches, seconds of
        each batch: from its sample_batch call to the next one's, the last
        to the end of main, which waits for the writer)."""
        for mod in (fa, tk, tc):
            mod.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        starts.clear()
        with mock.patch.dict(os.environ, env or {}):
            text_to_mscoco.main([
                "--model", "sdxl", "--method", MSCOCO_SOLVER,
                "--cfg_guidance", str(MSCOCO_GUIDANCE), "--NFE",
                str(MSCOCO_NFE), "--batch_size", str(MSCOCO_BATCH),
                "--device", "cuda", "--prompt_dir", str(prompt_file),
                "--workdir", str(workdir), *extra])
        end = time.perf_counter()
        return launches(), [b - a for a, b in zip(starts, starts[1:] + [end])]

    def png(path: Path) -> np.ndarray:
        return read_png(path.read_bytes())

    def level_diff(a: np.ndarray, b: np.ndarray):
        a, b = torch.from_numpy(a).float(), torch.from_numpy(b).float()
        return rel_l2(a, b), int((a - b).abs().max().item())

    runs = {}
    with mock.patch.object(text_to_mscoco, "build_engine", build_engine), \
            mock.patch.object(text_to_img, "build_engine", build_engine), \
            mock.patch.object(DiffusionEngine, "sample_batch", timed_batch):
        prompt_file = tmp / "prompts.txt"
        prompt_file.write_text("\n".join(MSCOCO_PROMPTS) + "\n")
        n_prompts = len(MSCOCO_PROMPTS)
        n_batches = -(-n_prompts // MSCOCO_BATCH)

        # 1. the README's command: two batches, the second padded
        coco = tmp / "coco"
        runs["sdxl mscoco b8"], batch_s = mscoco(coco)
        peak = torch.cuda.max_memory_allocated() / 2**30
        stats = json.loads((coco / "generation_stats.json").read_text())
        print(f"  sdxl bundle built by the CLI in {made['seconds']:.2f} s;"
              f" text_to_mscoco {MSCOCO_SOLVER} lambda={MSCOCO_GUIDANCE}"
              f" {MSCOCO_NFE} NFE --batch_size {MSCOCO_BATCH}: {n_prompts}"
              f" prompts, {stats['images_per_sec']:.4f} img/s over"
              f" {stats['seconds']:.2f} s, batches"
              f" {[round(x, 3) for x in batch_s]} s, launches"
              f" {runs['sdxl mscoco b8']}, peak device memory {peak:.2f} GiB"
              f" at UNet batch {2 * MSCOCO_BATCH} [{card}]", flush=True)
        for i in range(n_prompts):
            img = load_image(coco / f"{i:05d}.png", size=res, centered=False)
            check(img.shape == (1, res, res, 3),
                  f"{i:05d}.png: {img.shape}, expected a {res}^2 RGB image")
        padded = [i for i in range(n_prompts, n_batches * MSCOCO_BATCH)
                  if (coco / f"{i:05d}.png").exists()]
        check(not padded, f"files written for padded slots {padded}")
        check(stats["num_images"] == n_prompts,
              f"generation_stats.json num_images {stats['num_images']}")
        check(runs["sdxl mscoco b8"] == expect(
            n_batches * MSCOCO_LAUNCHES_PER_BATCH),
            f"mscoco launches {runs['sdxl mscoco b8']}, expected"
            f" {n_batches * MSCOCO_LAUNCHES_PER_BATCH}")

        # 2. --resume: the first batch skipped, the second regenerated
        first = {i: (coco / f"{i:05d}.png").stat().st_mtime_ns
                 for i in range(MSCOCO_BATCH)}
        (coco / f"{n_prompts - 1:05d}.png").unlink()
        runs["sdxl mscoco resume"], resume_s = mscoco(coco, "--resume")
        stats = json.loads((coco / "generation_stats.json").read_text())
        moved = [i for i, t in first.items()
                 if (coco / f"{i:05d}.png").stat().st_mtime_ns != t]
        print(f"  --resume after deleting {n_prompts - 1:05d}.png: batches"
              f" {[round(x, 3) for x in resume_s]} s, launches"
              f" {runs['sdxl mscoco resume']}, num_images"
              f" {stats['num_images']}, first batch rewritten: {moved}"
              f" [{card}]", flush=True)
        check(not moved, f"--resume rewrote the first batch's files {moved}")
        check((coco / f"{n_prompts - 1:05d}.png").is_file(),
              "--resume did not regenerate the deleted image")
        check(stats["num_images"] == n_prompts - MSCOCO_BATCH,
              f"--resume num_images {stats['num_images']}")
        check(runs["sdxl mscoco resume"] == expect(MSCOCO_LAUNCHES_PER_BATCH),
              f"--resume launches {runs['sdxl mscoco resume']}")

        # 3. batch invariance: the last index drawn alone
        engine = DiffusionEngine(made["bundle"], MSCOCO_SOLVER, nfe=MSCOCO_NFE)
        last = n_prompts - 1
        solo = engine.sample_batch(
            common.DEFAULT_NULL_PROMPT, [MSCOCO_PROMPTS[last]],
            cfg_guidance=MSCOCO_GUIDANCE, seed=SEED, resolution=res,
            sample_indices=[last], to_uint8=True)[0]
        rel, levels = level_diff(solo, png(coco / f"{last:05d}.png"))
        print(f"  index {last} alone (UNet batch 2) against the batch-8 image:"
              f" rel_l2 {rel:.3e} (tol {INVARIANCE_REL_L2_TOL}), largest"
              f" difference {levels} uint8 levels", flush=True)
        check(rel <= INVARIANCE_REL_L2_TOL, "batch invariance: index"
              f" {last} alone differs from the batch-8 image by {rel}")

        # 4. two ranks on the one card, one after the other
        ranks = tmp / "ranks"
        for r in (0, 1):
            label = f"sdxl mscoco rank{r}"
            runs[label], _ = mscoco(
                ranks, "--num_prompts", "2", "--batch_size", "2",
                env={"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": "0"})
            stats = json.loads(
                (ranks / f"generation_stats.rank{r}.json").read_text())
            written = sorted(p.name for p in ranks.glob("0*.png"))
            rel, levels = level_diff(png(ranks / f"{r:05d}.png"),
                                     png(coco / f"{r:05d}.png"))
            print(f"  rank {r} of 2: files {written}, num_images"
                  f" {stats['num_images']}, launches {runs[label]}; image {r}"
                  f" against the batch-8 run's: rel_l2 {rel:.3e}, largest"
                  f" difference {levels} uint8 levels", flush=True)
            check(written == [f"{i:05d}.png" for i in range(r + 1)]
                  and stats["num_images"] == 1,
                  f"rank {r}: files {written}, stats {stats}")
            check(runs[label] == expect(MSCOCO_NFE * SDXL_SITES_PER_CALL + 1),
                  f"rank {r}: launches {runs[label]}")
            check(rel <= INVARIANCE_REL_L2_TOL, f"rank {r}: image {r} differs"
                  f" from the batch-8 run's by {rel}")

        # 5. callbacks, fused and unrolled
        t2i = tmp / "t2i"
        for mod in (fa, tk, tc):
            mod.reset_launches()
        t0 = time.perf_counter()
        text_to_img.main([
            "--model", "sdxl", "--method", MSCOCO_SOLVER, "--cfg_guidance",
            str(MSCOCO_GUIDANCE), "--NFE", str(MSCOCO_NFE), "--callbacks",
            "draw_tweedie", "draw_noisy", "--callback_frequency",
            str(CALLBACK_FREQUENCY), "--device", "cuda", "--prompt",
            PROMPTS[0], "--workdir", str(t2i)])
        runs["sdxl callbacks"] = launches()
        ts = engine.plan.coeffs["t"]
        records = {sub: sorted(p.name for p in (t2i / "record" / sub).iterdir())
                   for sub in ("tweedie", "noisy")}
        print(f"  text_to_img --callbacks draw_tweedie draw_noisy"
              f" --callback_frequency {CALLBACK_FREQUENCY}:"
              f" {time.perf_counter() - t0:.2f} s, launches"
              f" {runs['sdxl callbacks']}, record/ {records} [{card}]",
              flush=True)
        for sub, prefix in (("tweedie", "x0"), ("noisy", "xt")):
            want = sorted(f"{prefix}_{int(ts[i])}.png" for i in CALLBACK_STEPS)
            check(records[sub] == want, f"record/{sub}: {records[sub]},"
                  f" expected {want}")
        check(runs["sdxl callbacks"] == expect(CALLBACK_LAUNCHES),
              f"callback request launches {runs['sdxl callbacks']}, expected"
              f" {CALLBACK_LAUNCHES}")

        def request(**kw):
            return engine.sample([common.DEFAULT_NULL_PROMPT, PROMPTS[0]],
                                 cfg_guidance=MSCOCO_GUIDANCE, seed=SEED,
                                 resolution=res, **kw)

        def halve_zt(step, t, kw):
            return dict(kw, zt=kw["zt"] * 0.5) if step == 0 else kw

        def diff(a, b) -> float:
            return (a - b).abs().max().item()

        callback = ComposeCallback(tmp / "engine", ["draw_tweedie",
                                                    "draw_noisy"],
                                   frequency=CALLBACK_FREQUENCY)
        plain = request()
        spread = diff(request(), plain)
        fused = request(callback_fn=callback)
        unrolled = request(callback_fn=callback, unrolled=True)
        halved = request(callback_fn=halve_zt, unrolled=True)
        replayed = request(callback_fn=halve_zt)
        cli_png = png(t2i / "result" / "generated.png")
        want_png = to_uint8(normalize(plain[0].cpu().numpy()))
        cli_levels = int(np.abs(cli_png.astype(int) - want_png).max())
        print(f"  one request twice: max difference {spread:.3e}; with"
              f" callbacks (fused) against without {diff(fused, plain):.3e},"
              f" unrolled against fused {diff(unrolled, fused):.3e}; zt"
              f" halved at step 0: unrolled {diff(halved, plain):.3e},"
              f" fused (replayed, ignored) {diff(replayed, plain):.3e}; the"
              f" CLI's PNG against the request without callbacks"
              f" {cli_levels} uint8 levels", flush=True)
        check(diff(fused, plain) <= spread, "the fused callbacks changed"
              " the image")
        check(diff(unrolled, fused) <= spread, "unrolled differs from fused")
        check(diff(halved, plain) > spread, "halving zt under unrolled=True"
              " did not change the image")
        check(diff(replayed, plain) <= spread, "a replayed callback's"
              " mutation changed the image")
        check(cli_levels <= (0 if spread == 0 else 1), "text_to_img with"
              f" callbacks differs from the request without by {cli_levels}"
              " levels")
    del engine, made["bundle"]
    torch.cuda.empty_cache()
    print(f"  phase 11 wall time {time.perf_counter() - started:.1f} s"
          f" [{card}]", flush=True)
    return runs


def per_second(fn, n: int) -> float:
    """Items a second of ``fn`` over ``n`` items, host clock."""
    t0 = time.perf_counter()
    fn()
    return n / (time.perf_counter() - t0)


def tower_rate(fn, batch: int, reps: int = 3) -> float:
    """Items a second of one batched tower call on the card (CUDA events
    over ``reps`` calls after a warm-up)."""
    return batch / (time_ms(fn, reps) / 1e3)


def phase_metrics(fa, tk, tc, card: str, images: Path, work: Path) -> dict:
    """The metric CLI on phase 11's ten 1024^2 images: full-width towers
    (InceptionV3 at 299^2, CLIP ViT-L/14 at 224^2, VGG16 LPIPS at 1024^2)
    with seeded random weights written in the published layouts
    (``tools/metric_synth.py``: a pytorch-fid ``.pth``, torchvision's VGG16
    and the LPIPS heads as ``.pth``, a combined CLIPModel ``.safetensors``
    by the port's own writer, a BPE vocabulary in the real files' layout).
    Paired labels: each image plus seeded integer noise in [-8, 8], as
    PNGs of the same names; distribution labels: the committed JPEG
    fixtures (COCO's mixed sizes, so Inception takes its host-resize path).
    Checks: the fixtures decode bit for bit to their stored PIL decodes;
    ``calculate_metrics.main`` with every flag and ``--device cuda`` (no
    kernel of the port launched) gives every key finite, 10 pairs, PSNR and
    MSE exactly numpy's on the same uint8 arrays, CLIP-score in (0, 100],
    LPIPS >= 0; LPIPS of the images against themselves exactly 0; FID and
    CLIP-FID against the JPEG labels; the card's Inception, CLIP image and
    text features and LPIPS values against the port on the CPU (TF32 off);
    FIDs from the card's features against the CPU's; a self-FID; the CLI's
    FID, CLIP-FID, CLIP-score and LPIPS against the same metrics from the
    CPU's features (every text-image cosine positive, and a shifted pairing
    outside the tolerance).  Records
    decode, host-transform and tower rates, the CLI's wall time, peak
    device memory and the FID with cuDNN TF32 on, and projects a
    10k-image FID against COCO's references.  Returns the numbers."""
    from importlib import import_module

    from cfgpp_tpu_torch.cli import calculate_metrics
    from cfgpp_tpu_torch.configs import CLIPTextConfig
    from cfgpp_tpu_torch.metrics.fid import compute_stats, fid_from_features
    from cfgpp_tpu_torch.metrics.lpips import LPIPS, convert_vgg16_lpips
    from cfgpp_tpu_torch.models.clip import CLIPTextModel
    from cfgpp_tpu_torch.tools import metric_synth
    from cfgpp_tpu_torch.utils.img import (AsyncImageReader, AsyncPngWriter,
                                           read_image, read_png)
    from cfgpp_tpu_torch.utils.jpeg import decode_jpeg
    from cfgpp_tpu_torch.weights.convert import clip_text_from_hf, load_module_
    from cfgpp_tpu_torch.weights.safetensors_io import save_file
    from cfgpp_tpu_torch.weights.tokenizer import load_tokenizer

    inception = import_module("cfgpp_tpu_torch.metrics.inception")
    clip_score = import_module("cfgpp_tpu_torch.metrics.clip_score")
    started = time.perf_counter()
    names = sorted(p.name for p in images.glob("*.png"))
    check(names == [f"{i:05d}.png" for i in range(len(MSCOCO_PROMPTS))],
          f"phase 12: phase 11's images {names}")
    rec: dict = {}

    # 1. weights in the published layouts, and a vocabulary
    wdir = work / "metric_weights"
    wdir.mkdir()
    ckpt = {"inception": wdir / "pt_inception-2015-12-05.pth",
            "vgg": wdir / "vgg16.pth", "lpips": wdir / "lpips_vgg.pth",
            "clip": wdir / "clip_vit_large_patch14.safetensors"}
    t0 = time.perf_counter()
    torch.save(metric_synth.inception_state(0), ckpt["inception"])
    torch.save(metric_synth.vgg16_state(1), ckpt["vgg"])
    torch.save(metric_synth.lpips_heads_state(2), ckpt["lpips"])
    clip_state = metric_synth.clip_model_state(3)
    save_file(clip_state, ckpt["clip"])
    n_clip = sum(v.numel() for k, v in clip_state.items()
                 if not k.endswith("position_ids"))
    del clip_state
    tokenizer = metric_synth.write_clip_vocab(wdir / "tokenizer")
    print(f"  random weights written in {time.perf_counter() - t0:.2f} s:"
          + ", ".join(f" {k} {p.stat().st_size / 1e6:.1f} MB"
                      for k, p in ckpt.items())
          + f" (CLIP ViT-L/14 {n_clip / 1e6:.1f} M parameters)", flush=True)

    # 2. inputs: paired labels, prompts, the JPEG fixtures
    gens = {n: read_png((images / n).read_bytes()) for n in names}
    paired = work / "labels_paired"
    rng = np.random.default_rng(SEED)
    labels = {}
    with AsyncPngWriter() as writer:
        for n in names:
            noise = rng.integers(-LABEL_NOISE, LABEL_NOISE + 1, gens[n].shape)
            labels[n] = np.clip(gens[n].astype(np.int64) + noise, 0,
                                255).astype(np.uint8)
            writer.submit(paired / n, labels[n])
    check(not writer.errors, f"paired label writes failed: {writer.errors}")
    prompts = work / "metric_prompts.txt"
    prompts.write_text("\n".join(MSCOCO_PROMPTS) + "\n")
    jpgs = sorted(JPEG_FIXTURES.glob("*.jpg"))
    check(len(jpgs) == 4, f"JPEG fixtures {jpgs}")
    gen_paths = [str(images / n) for n in names]
    paired_paths = [str(paired / n) for n in names]
    jpg_paths = [str(p) for p in jpgs]

    # 3. the fixtures decode bit for bit to their stored PIL decodes
    for jpg in jpgs:
        got = read_image(jpg)
        want = read_png(jpg.with_suffix(".png").read_bytes())
        check(got.shape == want.shape and np.array_equal(got, want),
              f"{jpg.name}: the decoder differs from PIL's stored decode")
    print(f"  JPEG fixtures bit for bit PIL's decodes: "
          + ", ".join(f"{p.name} {read_image(p).shape[1]}x"
                      f"{read_image(p).shape[0]}" for p in jpgs), flush=True)

    # 4. the CLI with every flag on the card
    for mod in (fa, tk, tc):
        mod.reset_launches()
    reads = counters(fa, tk, tc)
    out_json = work / "metrics.json"
    argv = ["--input_dir", images, "--label_dir", paired,
            "--inception_ckpt", ckpt["inception"], "--clip_ckpt", ckpt["clip"],
            "--prompts", prompts, "--tokenizer_dir", tokenizer,
            "--vgg_ckpt", ckpt["vgg"], "--lpips_ckpt", ckpt["lpips"],
            "--out", out_json, "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    res, rec["cli_s"] = timed(lambda: calculate_metrics.main(
        [str(a) for a in argv]))
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    launched = {name: read() for name, read in reads.items()}
    keys = ["psnr", "mse", "n_pairs", "fid", "clip_fid", "clip_score", "lpips"]
    print(f"  calculate_metrics (every flag, --device cuda, TF32 off):"
          f" {json.dumps(res)} in {rec['cli_s']:.2f} s, peak device memory"
          f" {rec['peak_gib']:.2f} GiB, kernel launches {launched} [{card}]",
          flush=True)
    check(json.loads(out_json.read_text()) == res, "--out differs from stdout")
    check(list(res) == keys, f"metric keys {list(res)}")
    check(all(np.isfinite(res[k]) for k in keys), f"non-finite metric {res}")
    check(res["n_pairs"] == len(names), f"n_pairs {res['n_pairs']}")
    check(not any(launched.values()), f"the metric path launched {launched}")
    mses = [np.mean((gens[n].astype(np.float64)
                     - labels[n].astype(np.float64)) ** 2) for n in names]
    psnrs = [10.0 * np.log10(255.0 ** 2 / m) for m in mses]
    check(res["mse"] == float(np.mean(mses))
          and res["psnr"] == float(np.mean(psnrs)),
          f"psnr/mse {res['psnr']}/{res['mse']} against numpy's"
          f" {np.mean(psnrs)}/{np.mean(mses)}")
    check(0.0 < res["clip_score"] <= 100.0, f"clip_score {res['clip_score']}")
    check(res["lpips"] >= 0.0, f"lpips {res['lpips']}")

    # 5. LPIPS of the images against themselves
    self_lpips = calculate_metrics.lpips_metric(
        images, images, str(ckpt["vgg"]), str(ckpt["lpips"]), device="cuda")
    check(self_lpips == 0.0, f"LPIPS(A, A) = {self_lpips}")

    # 6. features on the card, FID and CLIP-FID against the JPEG labels
    def features(device: str) -> dict:
        return {
            "inception gen": inception.inception_features(
                gen_paths, str(ckpt["inception"]), device=device),
            "inception jpeg": inception.inception_features(
                jpg_paths, str(ckpt["inception"]), device=device),
            "inception paired": inception.inception_features(
                paired_paths, str(ckpt["inception"]), device=device),
            "clip image gen": clip_score.clip_image_features(
                gen_paths, str(ckpt["clip"]), device=device),
            "clip image jpeg": clip_score.clip_image_features(
                jpg_paths, str(ckpt["clip"]), device=device),
            "clip image paired": clip_score.clip_image_features(
                paired_paths, str(ckpt["clip"]), device=device),
            "clip text": clip_score.clip_text_features(
                MSCOCO_PROMPTS, str(ckpt["clip"]),
                tokenizer_dir=str(tokenizer), device=device)}

    def fids(f: dict) -> dict:
        return {"fid": fid_from_features(f["inception gen"],
                                         f["inception jpeg"]),
                "clip_fid": fid_from_features(f["clip image gen"],
                                              f["clip image jpeg"])}

    card_f = features("cuda")
    card_fid = fids(card_f)
    check(all(np.isfinite(v) for v in card_fid.values()),
          f"FID against the JPEG labels {card_fid}")

    # 7. the port on the CPU for the same files
    cpu_f, cpu_s = timed(lambda: features("cpu"))
    cpu_fid = fids(cpu_f)
    feat_rel = {k: float(np.linalg.norm(card_f[k] - cpu_f[k])
                         / np.linalg.norm(cpu_f[k])) for k in card_f}
    lp_state = convert_vgg16_lpips(clip_score._load_state(str(ckpt["vgg"])),
                                   clip_score._load_state(str(ckpt["lpips"])))
    devices = (("card", "cuda"), ("cpu", "cpu"))
    lp = {}
    for key, dev in devices:
        lp[key] = LPIPS().to(dev).eval()
        load_module_(lp[key], lp_state, "lpips")
    def unit(arrays: dict, lo: int, hi: int) -> np.ndarray:
        return np.stack([arrays[n] for n in names[lo:hi]]
                        ).astype(np.float32) / 127.5 - 1.0

    pa, pb = unit(gens, 0, LPIPS_CPU_PAIRS), unit(labels, 0, LPIPS_CPU_PAIRS)
    b_lp = METRIC_BATCH["lpips"]
    with torch.no_grad():
        lp_vals = {"cpu": lp["cpu"](torch.from_numpy(pa),
                                    torch.from_numpy(pb)).numpy(),
                   "card": np.concatenate([lp["card"](
                       torch.from_numpy(unit(gens, i, i + b_lp)).cuda(),
                       torch.from_numpy(unit(labels, i, i + b_lp)).cuda()
                   ).cpu().numpy() for i in range(0, len(names), b_lp)])}
    feat_rel["lpips values"] = float(
        np.linalg.norm(lp_vals["card"][:LPIPS_CPU_PAIRS] - lp_vals["cpu"])
        / np.linalg.norm(lp_vals["cpu"]))
    fid_rel = {k: abs(card_fid[k] - cpu_fid[k]) / abs(cpu_fid[k])
               for k in card_fid}
    stats = compute_stats(card_f["inception gen"])
    self_fid = fid_from_features(card_f["inception gen"],
                                 card_f["inception gen"])
    trace = 2.0 * float(np.trace(stats[1]))
    print(f"  against the JPEG labels (mixed sizes, host resize): FID"
          f" {card_fid['fid']:.6f} (CPU {cpu_fid['fid']:.6f}, rel"
          f" {fid_rel['fid']:.3e}), CLIP-FID {card_fid['clip_fid']:.6e} (CPU"
          f" {cpu_fid['clip_fid']:.6e}, rel {fid_rel['clip_fid']:.3e}; tol"
          f" {METRIC_FID_REL_TOL}); card against CPU features rel-L2"
          f" {', '.join(f'{k} {v:.3e}' for k, v in feat_rel.items())} (tol"
          f" {METRIC_REL_L2_TOL}; LPIPS of {LPIPS_CPU_PAIRS} pairs, card"
          f" {lp_vals['card'][:LPIPS_CPU_PAIRS].tolist()}); self-FID {self_fid:.3e} ="
          f" {abs(self_fid) / trace:.3e} x (tr S1 + tr S2) (tol"
          f" {SELF_FID_TRACE_SHARE}); CPU features in {cpu_s:.1f} s [{card}]",
          flush=True)
    for k, v in feat_rel.items():
        check(v <= METRIC_REL_L2_TOL, f"{k}: card against CPU rel-L2 {v}")
    for k, v in fid_rel.items():
        check(v <= METRIC_FID_REL_TOL, f"{k}: card against CPU rel {v}")
    check(abs(self_fid) <= SELF_FID_TRACE_SHARE * trace,
          f"self-FID {self_fid} against the trace {trace}")

    # 7b. the CLI's own numbers against the same metrics worked out from the
    # CPU's features of the same files (LPIPS: the mean of the card's
    # per-pair values above, whose first pairs the CPU's hold); CLIP-score
    # with every cosine positive (no clamp at 0), and a pairing shifted by
    # one image would miss it
    cos = np.sum(cpu_f["clip text"] * cpu_f["clip image gen"], axis=-1)
    want = {"fid": fid_from_features(cpu_f["inception gen"],
                                     cpu_f["inception paired"]),
            "clip_fid": fid_from_features(cpu_f["clip image gen"],
                                          cpu_f["clip image paired"]),
            "clip_score": clip_score.clip_score_from_features(
                cpu_f["clip text"], cpu_f["clip image gen"]),
            "lpips": float(np.mean(lp_vals["card"]))}
    cli_tol = {"fid": METRIC_FID_REL_TOL, "clip_fid": METRIC_FID_REL_TOL,
               "clip_score": METRIC_REL_L2_TOL, "lpips": METRIC_REL_L2_TOL}
    cli_rel = {k: abs(res[k] - w) / abs(w) for k, w in want.items()}
    shifted = clip_score.clip_score_from_features(
        cpu_f["clip text"], np.roll(cpu_f["clip image gen"], 1, axis=0))
    shifted_rel = abs(shifted - want["clip_score"]) / want["clip_score"]
    print(f"  the CLI against the metrics from the CPU's features: "
          + ", ".join(f"{k} {res[k]:.6e} against {w:.6e} (rel"
                      f" {cli_rel[k]:.3e}, tol {cli_tol[k]})"
                      for k, w in want.items())
          + f"; text-image cosines {cos.min():.4f} to {cos.max():.4f};"
          f" CLIP-score with the images shifted by one {shifted:.6f} (rel"
          f" {shifted_rel:.3e}) [{card}]", flush=True)
    for k, v in cli_rel.items():
        check(v <= cli_tol[k], f"the CLI's {k} {res[k]} against {want[k]}"
              f" from the CPU's features: rel {v}")
    check(cos.min() > 0.0, f"text-image cosines {cos.tolist()}: CLIP-score"
          " would be clamped")
    check(shifted_rel > cli_tol["clip_score"],
          f"CLIP-score with the images shifted by one {shifted} is within"
          f" the tolerance of the paired {want['clip_score']}")

    # 8. cuDNN TF32 on (torch's default, the CLI's setting) against off
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_fid = fid_from_features(*(
            inception.inception_features(p, str(ckpt["inception"]),
                                         device="cuda")
            for p in (gen_paths, jpg_paths)))
        inc = inception._cached_extractor(str(ckpt["inception"]), "cuda")
        x_inc = torch.rand(METRIC_BATCH["inception"], SDXL_RESOLUTION,
                           SDXL_RESOLUTION, 3, device="cuda")
        lp_a = torch.from_numpy(np.concatenate(
            [pa] * (METRIC_BATCH["lpips"] // LPIPS_CPU_PAIRS))).cuda()
        lp_b = torch.from_numpy(np.concatenate(
            [pb] * (METRIC_BATCH["lpips"] // LPIPS_CPU_PAIRS))).cuda()
        with torch.no_grad():
            rec["inception img/s tf32"] = tower_rate(
                lambda: inc(x_inc), METRIC_BATCH["inception"])
            rec["lpips pairs/s tf32"] = tower_rate(
                lambda: lp["card"](lp_a, lp_b), METRIC_BATCH["lpips"], reps=2)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    rec["fid tf32 rel"] = abs(tf32_fid - card_fid["fid"]) / abs(card_fid["fid"])
    print(f"  FID against the JPEG labels with cuDNN TF32 on {tf32_fid:.6f},"
          f" off {card_fid['fid']:.6f}: rel {rec['fid tf32 rel']:.3e}"
          f" [{card}]", flush=True)

    # 9. rates: towers on the card (TF32 off), decodes and host transforms
    vision = clip_score._cached_vision_extractor(str(ckpt["clip"]), "cuda")
    text = CLIPTextModel(CLIPTextConfig(projection_dim=768)).cuda().eval()
    load_module_(text, clip_text_from_hf(clip_score._load_state(
        str(ckpt["clip"]))), "clip text")
    ids = torch.from_numpy(load_tokenizer(str(tokenizer))(
        [MSCOCO_PROMPTS[i % len(MSCOCO_PROMPTS)]
         for i in range(METRIC_BATCH["clip_text"])])).long().cuda()
    x_clip = torch.randn(METRIC_BATCH["clip_image"], 224, 224, 3,
                         device="cuda")
    with torch.no_grad():
        rec["inception img/s"] = tower_rate(lambda: inc(x_inc),
                                            METRIC_BATCH["inception"])
        rec["clip image img/s"] = tower_rate(lambda: vision(x_clip),
                                             METRIC_BATCH["clip_image"])
        rec["clip text prompts/s"] = tower_rate(lambda: text(ids),
                                                METRIC_BATCH["clip_text"])
        rec["lpips pairs/s"] = tower_rate(lambda: lp["card"](lp_a, lp_b),
                                          METRIC_BATCH["lpips"], reps=2)
    jpg640 = JPEG_FIXTURES / "coco_640x480.jpg"
    data640 = jpg640.read_bytes()
    rec["jpeg/s one core"] = per_second(
        lambda: [decode_jpeg(data640) for _ in range(5)], 5)

    def drain(paths, transform=None):
        """Items a second through a new reader, after its first item (the
        pool's start-up, recorded apart as ``first_s``)."""
        t0 = time.perf_counter()
        with AsyncImageReader(paths, transform=transform) as reader:
            reader.get(0)
            t1 = time.perf_counter()
            for i in range(1, len(paths)):
                reader.get(i)
            t2 = time.perf_counter()
        rec["first_s"] = max(rec.get("first_s", 0.0), t1 - t0)
        return (len(paths) - 1) / (t2 - t1)

    n_pool = 16 * min(8, os.cpu_count() or 1)
    rec["jpeg/s pool"] = drain([jpg640] * n_pool)
    rec["jpeg+299/s pool"] = drain([jpg640] * n_pool, inception._to_299)
    rec["jpeg+224/s pool"] = drain([jpg640] * n_pool, clip_score.load224)
    gen_bytes = [(images / n).read_bytes() for n in names]
    rec["png/s one thread"] = per_second(
        lambda: [read_png(b) for b in gen_bytes], len(gen_bytes))
    rec["png/s threads"] = drain(gen_paths * 8)
    rec["png+224/s threads"] = drain(gen_paths * 4, clip_score.load224)
    # a 10k-image FID of the generated PNGs against COCO's JPEGs: each
    # directory's decodes overlap its tower calls (the reader's window)
    t_gen = max(TEN_K / rec["png/s threads"], TEN_K / rec["inception img/s tf32"])
    t_ref = max(TEN_K / rec["jpeg+299/s pool"],
                TEN_K / rec["inception img/s tf32"])
    rec["fid10k_s"] = t_gen + t_ref
    slowest = min(("JPEG decode + resize (host)", rec["jpeg+299/s pool"]),
                  ("PNG decode (host)", rec["png/s threads"]),
                  ("Inception (card)", rec["inception img/s tf32"]),
                  key=lambda kv: kv[1])[0]
    print(f"  rates: Inception {rec['inception img/s']:.1f} img/s (b50, 1024^2"
          f" in; TF32 on {rec['inception img/s tf32']:.1f}), CLIP image"
          f" {rec['clip image img/s']:.1f} img/s (b64), CLIP text"
          f" {rec['clip text prompts/s']:.1f} prompts/s (b256), LPIPS"
          f" {rec['lpips pairs/s']:.2f} pairs/s (b8 at 1024^2; TF32 on"
          f" {rec['lpips pairs/s tf32']:.2f}); JPEG 640x480 4:2:0"
          f" {rec['jpeg/s one core']:.2f}/s on one core,"
          f" {rec['jpeg/s pool']:.2f}/s with the pool"
          f" ({min(8, os.cpu_count() or 1)} processes, {n_pool} decodes,"
          f" after a start-up of at most {rec['first_s']:.2f} s to the first"
          f" image; with the 299 bilinear"
          f" {rec['jpeg+299/s pool']:.2f}/s, with load224"
          f" {rec['jpeg+224/s pool']:.2f}/s); PNG 1024^2"
          f" {rec['png/s one thread']:.2f}/s on one thread,"
          f" {rec['png/s threads']:.2f}/s on the reader's threads"
          f" ({rec['png+224/s threads']:.2f}/s with load224) [{card}]",
          flush=True)
    print(f"  projected FID of 10k generated 1024^2 PNGs against 10k COCO"
          f" JPEGs (TF32 on, as the CLI runs): {rec['fid10k_s']:.0f} s"
          f" ({t_gen:.0f} s the generated, {t_ref:.0f} s the references);"
          f" set by {slowest} [{card}]", flush=True)

    del vision, text, inc, lp
    inception._cached_extractor.cache_clear()
    clip_score._cached_vision_extractor.cache_clear()
    clip_score._load_state.cache_clear()
    for p in ckpt.values():
        p.unlink()
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - started
    print(f"  phase 12 wall time {rec['wall_s']:.1f} s [{card}]", flush=True)
    return rec


# Phase 13: the last modules on the card.  The ``--dump`` requests run the
# SD-1.5 slice's command (ddim_cfg++ family, lambda=0.6, 50 NFE, 512^2,
# bf16); an inversion or edit dump injects its source latent, so its VAE
# encode does not run: 100 UNet calls and the decode.
DUMP_SOLVERS = {"t2i": "ddim_cfg++", "inversion": "ddim_inversion_cfg++",
                "edit": "ddim_edit_cfg++"}
DUMP_LAUNCHES = {"t2i": LAUNCHES_PER_REQUEST,
                 "inversion": 2 * UNET_SITES_PER_CALL * NFE + 1,
                 "edit": 2 * UNET_SITES_PER_CALL * NFE + 1}
FLASH_KERNEL = "flash_fwd"      # the bf16 flash kernel's name in csrc/


def captured(fn, *args):
    """(what ``fn(*args)`` returns, the lines it printed); what it printed
    is not echoed (parity_check's per-step rows are long)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue().strip().splitlines()


def phase_last_modules(fa, tk, tc, card: str, work: Path,
                       drift: dict) -> None:
    """The modules of the port's last slice through their entry points:
    ``text_to_img --profile_dir`` (the trace holds the flash kernel's device
    events, one per launch), ``parity_check --dump`` of the three kinds on
    dumps the port's engine writes (each must PASS at the CLI's tolerance),
    ``parity_check --quant_drift`` at its default command and with
    ``--quant_mode dense`` (each WITHIN-INT8-BUDGET, its launches exactly an
    exact and a quantized request's) and ``tools/profile_bench.py``.
    Every count is set to 0 just before each run."""
    from cfgpp_tpu_torch.cli import parity_check, text_to_img
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
    from cfgpp_tpu_torch.tools import profile_bench
    from cfgpp_tpu_torch.utils.img import to_np
    from cfgpp_tpu_torch.weights.checkpoint import save_bundle

    work.mkdir(parents=True, exist_ok=True)
    reads = counters(fa, tk, tc)

    def reset():
        for mod in (fa, tk, tc):
            mod.reset_launches()

    def launches(expected: dict) -> dict:
        n = {name: read() for name, read in reads.items()}
        want = {name: expected.get(name, 0) for name in reads}
        return n, want

    # 1. text_to_img --profile_dir
    trace_dir = work / "trace"
    reset()
    t0 = time.perf_counter()
    text_to_img.main([
        "--model", "sd15", "--method", "ddim_cfg++", "--cfg_guidance",
        str(GUIDANCE), "--NFE", str(NFE), "--device", "cuda", "--prompt",
        PROMPTS[0], "--workdir", str(work / "t2i_profile"), "--profile_dir",
        str(trace_dir)])
    seconds = time.perf_counter() - t0
    n, want = launches({"flash_attention_hd": LAUNCHES_PER_REQUEST})
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    check(len(files) == 1, f"--profile_dir: trace files {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flash = [e for e in kernels if FLASH_KERNEL in e.get("name", "")]
    flash_ms = sum(e.get("dur", 0) for e in flash) / 1000.0
    print(f"  text_to_img --profile_dir: {seconds:.2f} s with the trace,"
          f" launches {n}; {files[0].name} {files[0].stat().st_size / 1e6:.1f}"
          f" MB, {len(events)} events, {len(kernels)} device kernels,"
          f" {len(flash)} of them {FLASH_KERNEL} ({flash_ms:.2f} ms)"
          f" [{card}]", flush=True)
    check(n == want, f"--profile_dir request: launches {n}, expected {want}")
    check(len(flash) == n["flash_attention_hd"],
          f"--profile_dir: {len(flash)} {FLASH_KERNEL} device events for"
          f" {n['flash_attention_hd']} launches")
    check((work / "t2i_profile" / "result" / "generated.png").is_file(),
          "--profile_dir: no generated.png")

    # 2. parity_check --dump, the three kinds, on the port's own dumps
    t0 = time.perf_counter()
    bundle = ModelBundle.random_init("sd15", seed=0, dtype=torch.bfloat16,
                                     device="cuda")
    ckpt = work / "sd15_ckpt"
    nbytes = save_bundle(bundle, ckpt)
    print(f"  random sd15 bundle written as an HF-layout directory"
          f" ({nbytes / 1e9:.2f} GB) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    rng = np.random.default_rng(SEED)
    s = RESOLUTION // bundle.vae_scale_factor
    for kind, solver in DUMP_SOLVERS.items():
        engine = DiffusionEngine(bundle, solver, nfe=NFE)
        lat = rng.standard_normal((1, s, s, 4), dtype=np.float32)
        prompts = ["", PROMPTS[1], PROMPTS[0]] if kind == "edit" \
            else ["", PROMPTS[0]]
        kw = ({"init_latent_override": lat} if kind == "t2i" else
              {"src_latent_override": lat,
               "src_img": np.zeros((1, RESOLUTION, RESOLUTION, 3), np.float32)})
        _, (z0s, zts) = engine.sample(prompts, cfg_guidance=GUIDANCE,
                                      resolution=RESOLUTION,
                                      return_trajectory=True, **kw)
        dump = {"zT": lat, "z0t": to_np(z0s), "zt": to_np(zts),
                "prompt": prompts[-1], "null_prompt": "",
                "cfg_guidance": GUIDANCE, "nfe": NFE, "method": solver,
                "model": "sd15", "kind": kind, "seed": SEED}
        if kind != "t2i":
            dump["src_latent"] = lat
        if kind == "edit":
            dump["src_prompt"] = prompts[1]
        check(set(dump) == set(parity_check.DUMP_SCHEMA[kind]),
              f"{kind} dump: keys {sorted(dump)}")
        path = work / f"{kind}.npz"
        np.savez(path, **dump)
        del engine
        reset()
        t0 = time.perf_counter()
        rc, lines = captured(parity_check.main,
                             ["--dump", str(path), "--ckpt_dir", str(ckpt)])
        out = json.loads(lines[-1])
        seconds = time.perf_counter() - t0
        n, want = launches({"flash_attention_hd": DUMP_LAUNCHES[kind]})
        print(f"  parity_check --dump {kind} ({solver}, {NFE} NFE,"
              f" {RESOLUTION}^2): {out['verdict']}, worst MAE"
              f" {out['worst_mae']:.3e} over {len(out['per_step'])} steps"
              f" (tolerance {out['tolerance']}), rc {rc}, {seconds:.2f} s,"
              f" launches {n} [{card}]", flush=True)
        check(rc == 0 and out["verdict"] == "PASS",
              f"parity_check --dump {kind}: rc {rc}, {out['verdict']}")
        check(len(out["per_step"]) == len(dump["z0t"]),
              f"--dump {kind}: {len(out['per_step'])} steps compared")
        check(n == want, f"--dump {kind}: launches {n}, expected {want}")
    del bundle
    torch.cuda.empty_cache()

    # 3. parity_check --quant_drift, the default command and dense
    for mode, extra in (("all", []), ("dense", ["--quant_mode", "dense"])):
        reset()
        t0 = time.perf_counter()
        rc, lines = captured(parity_check.main, ["--quant_drift", *extra])
        out = json.loads(lines[-1])
        seconds = time.perf_counter() - t0
        expected = {name: SDXL_LAUNCHES_PER_REQUEST["exact"].get(name, 0)
                    + SDXL_LAUNCHES_PER_REQUEST[mode].get(name, 0)
                    for name in reads}
        n, want = launches(expected)
        print(f"  parity_check --quant_drift{' ' if extra else ''}"
              f"{' '.join(extra)} ({out['model']}, {out['method']},"
              f" {out['nfe']} NFE): {out['verdict']}, worst rel-MAE"
              f" {out['worst_rel_mae']:.4f} (phase 9's sdxl {mode}:"
              f" {drift[f'sdxl {mode}']:.4f}; budget {out['rel_budget']}),"
              f" rc {rc}, {seconds:.1f} s, launches {n} [{card}]", flush=True)
        check(rc == 0 and out["verdict"] == "WITHIN-INT8-BUDGET"
              and out["mode"] == f"quant_drift[{mode}]"
              and (out["model"], out["method"], out["nfe"])
              == ("sdxl", SDXL_SOLVER, SDXL_NFE),
              f"parity_check --quant_drift {mode}: rc {rc}, {out['verdict']}")
        check(n == want, f"--quant_drift {mode}: launches {n}, expected"
              f" {want}")
        torch.cuda.empty_cache()

    # 4. tools/profile_bench.py
    t0 = time.perf_counter()
    rec, lines = captured(profile_bench.main, [])
    for line in lines[:-1]:       # its JSON record is summed up below
        print(f"  profile_bench: {line}" if line else "", flush=True)
    times = [rec["unet_call_s"], rec["host_enqueue_median_s"],
             rec["step_wall_median_s"], rec["modeled_total_s"],
             rec["request_device_s"]]
    print(f"  profile_bench: {rec['steps']} solver steps, host enqueue"
          f" median {rec['host_enqueue_median_s'] * 1000:.2f} ms, step wall"
          f" median {rec['step_wall_median_s'] * 1000:.2f} ms, one UNet call"
          f" {rec['unet_call_s'] * 1000:.2f} ms, in"
          f" {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    check(rec["steps"] == SDXL_CALLS and rec["card"] == card
          and all(np.isfinite(x) and x > 0 for x in times),
          f"profile_bench: {rec['steps']} steps, times {times}")
    torch.cuda.empty_cache()


# name: (source, the TPU kernel it replaces, the path whose run counts its
# launches).
KERNEL_SOURCES = {
    "flash_attention_hd": ("cfgpp_tpu_torch/csrc/flash_attention.cu",
                           "cfgpp_tpu/kernels/flash_attention.py:378", "all"),
    "flash_attention_qkv_packed": ("cfgpp_tpu_torch/csrc/flash_attention.cu",
                                   "cfgpp_tpu/kernels/flash_attention.py:614",
                                   "all"),
    "flash_attention_hd_f32": ("cfgpp_tpu_torch/csrc/flash_attention_f32.cu",
                               "cfgpp_tpu/kernels/flash_attention.py:378",
                               "f32"),
    "flash_attention_qkv_packed_f32": (
        "cfgpp_tpu_torch/csrc/flash_attention_f32.cu",
        "cfgpp_tpu/kernels/flash_attention.py:614", "f32"),
    "flash_attention_hd_int8": ("cfgpp_tpu_torch/csrc/flash_attention_int8.cu",
                                "cfgpp_tpu/kernels/flash_attention.py:470",
                                "all"),
    "flash_attention_qkv_packed_int8": (
        "cfgpp_tpu_torch/csrc/flash_attention_int8.cu",
        "cfgpp_tpu/kernels/flash_attention.py:544", "all"),
    "int8_matmul": ("cfgpp_tpu_torch/csrc/int8_matmul.cu",
                    "cfgpp_tpu/kernels/int8_matmul.py:163", "all"),
    "int8_ff_geglu": ("cfgpp_tpu_torch/csrc/int8_matmul.cu",
                      "cfgpp_tpu/kernels/int8_matmul.py:305", "all"),
    "int8_conv3x3": ("cfgpp_tpu_torch/csrc/int8_conv.cu",
                     "cfgpp_tpu/kernels/int8_conv.py:225", "all"),
    "int8_matmul_f32": ("cfgpp_tpu_torch/csrc/int8_matmul.cu",
                        "cfgpp_tpu/kernels/int8_matmul.py:163", "f32"),
    "int8_ff_geglu_f32": ("cfgpp_tpu_torch/csrc/int8_matmul.cu",
                          "cfgpp_tpu/kernels/int8_matmul.py:305", "f32"),
    "int8_conv3x3_f32": ("cfgpp_tpu_torch/csrc/int8_conv.cu",
                         "cfgpp_tpu/kernels/int8_conv.py:225", "f32"),
    "flash_attention_hd_int8_f32": (
        "cfgpp_tpu_torch/csrc/flash_attention_int8.cu",
        "cfgpp_tpu/kernels/flash_attention.py:470", "f32"),
    "flash_attention_qkv_packed_int8_f32": (
        "cfgpp_tpu_torch/csrc/flash_attention_int8.cu",
        "cfgpp_tpu/kernels/flash_attention.py:544", "f32"),
}


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs"
              " an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    if not (ROOT / "cfgpp_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no cfgpp_tpu_torch package beside {__file__}; run it"
              " from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from cfgpp_tpu_torch.engine import DiffusionEngine, ModelBundle
    from cfgpp_tpu_torch.kernels import build
    from cfgpp_tpu_torch.kernels import flash_attention as fa
    from cfgpp_tpu_torch.kernels import int8_conv as tc
    from cfgpp_tpu_torch.kernels import int8_matmul as tk
    from cfgpp_tpu_torch.models.quant import (quantize_conv_kernel_int8,
                                              quantize_kernel_int8)
    from cfgpp_tpu_torch.utils import roofline as rl

    # the plain versions are f32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    started = time.perf_counter()
    card = card_name_and_power()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    build_all(build)
    print("phase 1 ok: every CUDA library built and loaded", flush=True)

    table = KernelTable(card)
    phase_kernels(fa, tk, tc, rl, quantize_kernel_int8,
                  quantize_conv_kernel_int8, table)
    print(f"phase 2 ok: {len(KERNEL_SOURCES)} kernels match their plain"
          f" versions at {sum(map(len, table.rows.values()))} shapes",
          flush=True)

    t0 = time.perf_counter()
    bundle = ModelBundle.random_init("sd15", seed=0, dtype=torch.bfloat16,
                                     device="cuda")
    engine = DiffusionEngine(bundle, "ddim_cfg++", nfe=NFE)
    torch.cuda.synchronize()
    print(f"  random sd15 bundle on the card in {time.perf_counter() - t0:.2f} s",
          flush=True)
    phase_models_vs_plain_attention(engine, fa)
    launches = {}
    launches["exact"], traj_e = phase_slice_requests(
        engine, fa, tk, tc, card, "exact",
        {"flash_attention_hd": LAUNCHES_PER_REQUEST})
    print("phase 3 ok: SD-1.5 ddim_cfg++ exact slice, 3 requests", flush=True)

    engine_q = DiffusionEngine(bundle.quantized("dense"), "ddim_cfg++", nfe=NFE)
    phase_int8_unet_vs_plain(engine_q, fa, tk, tc, "int8",
                             INT8_MODEL_REL_L2_TOL)
    launches["dense"], traj_q = phase_slice_requests(
        engine_q, fa, tk, tc, card, "int8", INT8_LAUNCHES_PER_REQUEST)
    drift = {"dense": quant_drift(traj_e, traj_q, "int8")}
    print("phase 4 ok: SD-1.5 ddim_cfg++ int8 (--quant dense) slice, 3 requests",
          flush=True)
    del engine_q
    torch.cuda.empty_cache()

    engine_a = DiffusionEngine(bundle.quantized("all"), "ddim_cfg++", nfe=NFE)
    phase_int8_unet_vs_plain(engine_a, fa, tk, tc, "int8-all",
                             INT8_ALL_MODEL_REL_L2_TOL)
    launches["all"], traj_q = phase_slice_requests(
        engine_a, fa, tk, tc, card, "int8-all", ALL_LAUNCHES_PER_REQUEST)
    drift["all"] = quant_drift(traj_e, traj_q, "int8-all")
    print("phase 5 ok: SD-1.5 ddim_cfg++ int8-all (--quant all) slice,"
          " 3 requests", flush=True)
    del engine_a, engine, traj_e, traj_q
    torch.cuda.empty_cache()

    launches["f32"] = phase_f32(fa, tk, tc, card)
    print("phase 6 ok: f32 VAE encode and UNet call on the f32 attention"
          " kernel; f32 --quant dense and --quant all UNet calls on the int8"
          " kernels", flush=True)

    phase_solvers(bundle, fa, tk, tc, card)
    print(f"phase 7 ok: {len(SAMPLING_SOLVERS)} new sampling solvers and"
          f" {len(INVERSION_REQUESTS)} inversion/edit requests", flush=True)
    del bundle
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sd2_launches, sd2_drift = phase_sd2(fa, tk, tc, card)
    launches.update(sd2_launches)
    drift.update(sd2_drift)
    print(f"phase 8 ok: sd21_v at {SD2_RESOLUTION}^2, 3 exact, 1 --quant"
          " dense, 1 --quant all and 1 ddim_inversion_cfg++ request in"
          f" {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    t0 = time.perf_counter()
    sdxl_launches, sdxl_drift, _ = phase_sdxl(fa, tk, tc, card)
    launches.update(sdxl_launches)
    drift.update(sdxl_drift)
    print(f"phase 9 ok: sdxl at {SDXL_RESOLUTION}^2, {SDXL_SOLVER} w="
          f"{SDXL_GUIDANCE} {SDXL_NFE} NFE: 3 exact, 1 --quant dense, 1"
          f" --quant all and 1 {SDXL_EDIT_SOLVER} request in"
          f" {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    t0 = time.perf_counter()
    light_launches, light_drift, _ = phase_lightning(fa, tk, tc, card)
    launches.update(light_launches)
    drift[f"{LIGHTNING_MODEL} dense"] = light_drift
    print(f"phase 10 ok: {LIGHTNING_MODEL} at {SDXL_RESOLUTION}^2 from a"
          " single file through convert_checkpoint and from_pretrained (bit"
          f" for bit), {LIGHTNING_SOLVER} w={LIGHTNING_GUIDANCE}"
          f" {LIGHTNING_NFE} NFE: 3 exact and 1 --quant dense request, 1"
          f" request each of {', '.join(LIGHTNING_SOLVERS)} in"
          f" {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        t0 = time.perf_counter()
        launches.update(phase_mscoco(fa, tk, tc, card, work))
        print(f"phase 11 ok: text_to_mscoco on sdxl at {SDXL_RESOLUTION}^2,"
              f" {MSCOCO_SOLVER} lambda={MSCOCO_GUIDANCE} {MSCOCO_NFE} NFE"
              f" --batch_size {MSCOCO_BATCH} ({len(MSCOCO_PROMPTS)} prompts),"
              " --resume, batch invariance, two ranks, text_to_img"
              " --callbacks and the unrolled mode in"
              f" {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

        t0 = time.perf_counter()
        phase_metrics(fa, tk, tc, card, work / "coco", work)
        print("phase 12 ok: calculate_metrics on phase 11's images with"
              " every metric (InceptionV3 FID, CLIP ViT-L/14 CLIP-FID and"
              " CLIP-score, VGG-LPIPS, PSNR/MSE) at full width, the JPEG"
              " fixtures bit for bit, card against CPU features in"
              f" {time.perf_counter() - t0:.1f} s [{card}]", flush=True)

        t0 = time.perf_counter()
        phase_last_modules(fa, tk, tc, card, work / "last", drift)
        print("phase 13 ok: the last modules on the card: text_to_img"
              " --profile_dir (a trace with the flash kernel's device events),"
              " parity_check --dump (t2i, inversion, edit: PASS) and"
              " --quant_drift (all, dense: WITHIN-INT8-BUDGET),"
              f" tools/profile_bench.py in {time.perf_counter() - t0:.1f} s"
              f" [{card}]", flush=True)

    killed = stop_child_processes()
    print(f"  child processes stopped; killed beyond them: {killed or 'none'};"
          f" left below this process: {descendants(os.getpid()) or 'none'}",
          flush=True)
    check(not descendants(os.getpid()), "processes left below this one")

    kernels = []
    for name, (source, replaces, path) in KERNEL_SOURCES.items():
        summary = table.summary(name, {LIGHTNING_MODEL: (
            "sdxl", LIGHTNING_SITE_CALLS[name])}
            if name in LIGHTNING_SITE_CALLS else None)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[path][name],
            "max_abs_err": summary["max_abs_err"], "ms": summary["ms"],
            "plain_ms": summary["plain_ms"], "bound_ms": summary["bound_ms"],
            "bound_by": summary["bound_by"],
            "library_ms": summary["library_ms"],
            "ms_per": "SD-1.5 request: sum over its shapes of calls per"
                      " request (in the slice that runs each) x time per"
                      " call; the same for plain_ms, bound_ms and"
                      " library_ms; by_model: the same per model's request"
                      " (sd15, sd21_v, sdxl; sdxl_lightning: the sdxl shapes"
                      " at the ddim_cfg++_lightning request's calls, its"
                      " --quant dense request's for the int8 and packed"
                      " kernels; sdxl_lightning_b1: the batch-1 rows of a"
                      " ddim_lightning request, its decode not counted;"
                      " sdxl_mscoco_b16: one batch of 8 images of the"
                      " MS-COCO command, 50 UNet calls of batch 16 and 8"
                      " decodes)",
            "by_model": summary["by_model"],
            "launches_by_path": {path: n[name] for path, n in launches.items()
                                 if name in n},
            "shapes": summary["shapes"]})
    print(f"chip_smoke wall time {time.perf_counter() - started:.1f} s"
          f" [{card}]", flush=True)
    print(json.dumps({"kernels": kernels, "quant_drift": drift}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_child_processes()
