#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diffassemble_tpu_torch``) on one GPU.

    python3 chip_smoke.py                  # the smoke run
    python3 chip_smoke.py --profile        # one serving request under torch.profiler
    python3 chip_smoke.py --profile train  # one full-width train step under torch.profiler
    python3 chip_smoke.py --profile eval   # one held-out call of 32 puzzles, trained weights
    python3 chip_smoke.py --profile train-device  # one step of the device-resident recipe
    python3 chip_smoke.py --profile eval3d  # one 3D held-out call of 16 objects, trained weights
    python3 chip_smoke.py --profile train3d  # one full-width 3D train step

Phases, each ending in a line with the elapsed seconds:

1. environment: the card's name and power limit (nvidia-smi), device count;
2. build: the masked-attention kernels from ``csrc/`` with nvcc (one nvcc
   per source, in parallel; -Xptxas -v), failing if a tensor-core kernel
   spills registers;
3. the forward kernel against its plain PyTorch version on the card:
   the 10% expander + 8 virtual nodes at the main paths' batches (B = 1 for a
   request, B = 8 for a train step), the same with padded nodes and empty
   rows, fully connected, N = 200, and the held-out evaluation's committed
   expander + 8 virtual nodes at B = 32, at head widths 32 and 144, in bf16 and
   f32; then the two backward kernels (dQ, and dK/dV) against theirs over the
   same masks, with exact zeros on empty query rows and unattended keys. In
   bf16 at Dh 32 and 144 all three run on the tensor-core route, in f32 on
   the CUDA-core route; each line names its route, and a kernel on another
   route than its type and width call for fails. bf16 inputs 2 bytes off a
   16-byte boundary run all three on the CUDA-core route on the B = 1
   expander. Then all three kernels at the other head widths they take, 20,
   24, 40, 104, 136, 264 and 271 (odd: each bf16 head starts 2 bytes off a
   4-byte boundary), in both types, on the B = 1 expander and the
   padded/empty-rows masks; a head of 296 must raise;
4. timing of the three kernels, their plain versions and the PyTorch calls
   (``scaled_dot_product_attention`` forward, and one backward of it, which
   computes dQ, dK and dV together) at the serving shapes (B = 1, the
   forward), the training shapes (B = 8, all three) and the held-out
   evaluation's (B = 32, the forward), H = 8, N = 908; the
   same kernels on the CUDA-core route in bf16 (inputs 2 bytes off a 16-byte
   boundary take it); the tensor-core forward with 64-, 32- and 16-row query
   blocks (each bit-equal to the launch's own choice); at B = 8 the three
   kernels at Dh 20, 104 and 264;
5. serving, the first main path: the flagship 30×30 rotation config from
   ``weights/diffusion2d_rot30/config.json`` (JSON only) with seeded weights;
   one denoiser call with the kernel against the same call with plain
   attention; a 6×6 sample on the card against the CPU; then
   ``PuzzleSolver.predict_array`` on 3 seeded 960×960 images, with exactly
   120 forward launches (4 layers × 30 steps), all on the tensor cores, and
   no backward launch each;
6. training: a full-width f32 step's gradients with the kernels against the
   same step with plain attention (every query/key/value weight gets a
   finite, nonzero gradient); a 6×6 f32 train step on the card against the
   CPU; then the second main path, ``run_2d`` of the rotation CLI with the
   flagship's flags at batch 8 on 30×30 puzzles: a sanity eval, 3 steps
   with exactly 4 + 4 + 4 kernel launches each, all on the tensor cores, a
   checkpoint, and a resume that continues from it for 2 more steps;
7. accuracy, the third main path: the trained checkpoint (the EMA of
   ``weights/diffusion2d_rot30`` at step 32000, committed converted as
   ``diffassemble_tpu_torch/assets/diffusion2d_rot30_ema32000.npz``) under
   bench.py's held-out protocol in bf16: 64 synthetic 960×960 images, the
   committed expander and rotation draw, ``heldout_eval`` in two calls of 32
   puzzles with exactly 240 forward launches, all on the tensor cores; then
   the same over the four other expanders the recipe's seed can give (the
   seed leaves a choice among five with equal spectral gaps, so which one
   the TPU's run used is unknown). It fails unless the TPU's piece_acc of
   0.9763 is within 0.01 of the card's over one of the five. Then, ungated,
   the same puzzles over a fully connected graph and in calls of 8;
8. recipe, the fourth main path: the flagship's device-resident recipe
   through ``cli/train_device.py`` (config.json and data.json: 30×30, 10%
   expander, canonical 0.8, hf_detail 0.25, the encoder_init
   ``weights/efficientnet_b0_pose30hf.npz``, batch 8, EMA), cut to corpora
   of 16 and 8 puzzles and 6 steps with an evaluation every 3, then a
   resume to 8: 4 + 4 + 4 tensor-core launches a step, 120 a held-out call,
   finite losses, checkpoints at 3, 6 and 8, data.json equal to the
   arguments; steady s/step by host clock and CUDA events, peak memory and
   the corpora's bytes on the card;
9. one ``make_device_train_step`` step against one
   ``train_state.make_train_step`` step on the card, same weights, batch
   and draws;
10. mixed, the fifth main path: the mixed-size recipe of
   ``weights/diffusion2d_rot_ms`` (its config.json: resnet18equiv at the
   flagship's widths; its data.json: 6/8/10/12 padded to 144 pieces) from
   seeded weights at batch 16, 3 steps and a resume to 4, with evaluations,
   all on the tensor cores, and its seeded f32 loss card against CPU; then
   the three kernels against their plain versions on its masks (B = 16, N =
   152 with padding rows and unattended keys; bf16 on the tensor cores, f32
   on the CUDA cores) and timed there beside their bound and
   ``scaled_dot_product_attention``; then the forward kernel against its
   plain version on a 6×6 request's mask (B = 1, N = 44, fully connected)
   at Dh 32 and 144 in bf16 and f32, timed there; ``serve --run_dir`` on
   that run after its OrientationNorm statistics were calibrated and written
   as ``norm_stats.npz`` (120 forward launches, the statistics frozen); then the
   trained ``diffusion2d_rot_ms`` (step 7000, committed converted) through
   ``cli/train_device.py --evaluate_npz`` under its run's protocol (64
   puzzles in calls of 16, the JAX rotation draw, bf16): 480 forward
   launches on the tensor cores, piece_acc within 0.01 of the TPU's 0.99967,
   the per-size figures, the JAX package's CPU figure and ms per call
   printed;
11. ddp: one ``Trainer`` step at full width under DDP in a world of one
   over NCCL, bit-equal to the same step without DDP; then the discrete
   family: the three kernels against their plain versions on the discrete
   protocol's masks (the committed 60% expander over 36 pieces + 8 virtual
   nodes, B = 32) and timed there; the trained ``diffusion2d_discrete_rot6``
   (step 6000) under ``scripts/tpu_train_variants.py``'s protocol
   (``train/heldout.py:run_protocol``: 64 6×6 puzzles in calls of 32, 30
   Gumbel steps each re-running the encoder on the re-rotated patches, bf16):
   240 forward launches on the tensor cores, piece_acc within 0.01 of the
   TPU's 1.0; the discrete-rotation model through ``cli/train_2d_rot.py
   --discrete true`` (6×6, batch 32, seeded weights, 2 steps and a resume to
   3, each 4 + 4 + 4 tensor-core launches) after its seeded f32 loss card
   against CPU; a seeded 6×6 ``AngleDiffusion2D`` sample card against CPU
   in f32 (1e-3), then in bf16 with 120 forward launches on the tensor
   cores;
12. 3D held-out, the sixth main path: the trained 3D SE(3) model
   (``weights/diffusion3d_easy`` at step 12000, bf16, committed converted
   as ``diffassemble_tpu_torch/assets/diffusion3d_easy12000.npz``) under
   ``scripts/tpu_eval_3d.py``'s protocol (64 synthetic objects, 512 points,
   2–8 parts, calls of 16, 30 DDIM steps). First the forward kernel against
   its plain version on the protocol's own masks (B = 16, N = 8, padding
   parts with empty rows) at Dh 32 and 264 in bf16 and f32, timed beside
   its bound over the attended pairs and SDPA; then the asset written as a
   port run and evaluated by ``cli/train_3d.py``'s ``run_3d --evaluate``,
   and the protocol through ``train/heldout3d.py``. Each call has exactly
   120 forward launches, 90 on the tensor cores (Dh 32) and 30 on the CUDA
   cores (Dh 264, ROADMAP K3), and no backward launch. It fails unless
   n_parts is 318, every metric is finite, and rmse_t, rmse_r and
   part_acc@0.05 lie within 0.005, 2° and 0.03 of the JAX package's CPU
   run of the protocol in bf16, and the metric's calibration scores the
   true poses at part_acc 1.0; the gauge-aligned diagnostic and the TPU's
   figures (``results/diagnostics/eval3d_easy12k.json``) are printed
   beside, ungated;
13. 3D training, the seventh main path: the configuration of
   ``weights/diffusion3d_easy`` with its run's flags (``TRAIN3D_FLAGS``:
   vn_dgcnn_rich from ``weights/vn_dgcnn_rich_rel3d_512.npz``, relative-pose
   conditioning and losses, aux-pose and rot-pt-l2 losses, bf16, batch 16 of
   512 points and 2–8 parts). First dQ and dK/dV (after the forward) against
   their plain versions on the masks of the run's first batch (B = 16, N =
   8, padding parts with empty rows and unattended keys) at Dh 32 (tensor
   cores) and 264 (CUDA cores) in bf16 and f32, with exact zeros, then
   timed beside their bound over the attended pairs and one SDPA backward;
   the trained weights' training loss on that batch with numpy draws, in
   bf16 and f32, against the JAX package's CPU values (``JAX_CPU_LOSS_3D``,
   ``TOL_LOSS_3D``); one f32 step's gradients with the kernels against plain
   attention. Then ``run_3d`` without ``--evaluate`` on a corpus cut to 48
   training and 16 held-out objects: a sanity evaluation, 4 steps with an
   evaluation and a checkpoint at step 4, a resume to step 6. Every step
   has exactly 8 launches of each kernel (the denoiser runs twice, its
   diffusion pass and the aux-pose pass), 6 on the tensor cores and 2 on the
   CUDA cores, finite losses and nonzero gradients in the encoder, the
   pairwise head and the denoiser; every evaluation call 120 forward
   launches and no backward. It prints s/step by host clock and CUDA events
   and the peak memory;
14. the three kernels at every head width of the 3D family (32 and the
   widths of phase 3) against their plain versions in bf16 and f32, with
   exact zeros and routes, on the 3D protocols' own masks: N = 8
   (``diffusion3d_easy``'s first call) and N = 20 (``diffusion3d_vndgcnn``'s,
   mostly padding rows); then timed at N = 20 at Dh 24, 32, 40, 104, 136 and
   271 and at N = 8 at Dh 136 beside their bound over the attended pairs and
   SDPA;
15. the other trained 3D checkpoints, the eighth main path: ``_relpose`` and
   ``_wallsurf`` (the latter refined by multiview ICP too) at ratio 10, and
   ``_vndgcnn`` (N = 20, its last layer Dh 104) at ratios 10 and 2, each
   through ``run_3d --evaluate`` and ``heldout3d``'s protocol, as phase 12:
   the forward launches a call on their routes (the two head widths on two
   routes), n_parts 318, the calibration, and each row's rmse_t, rmse_r and
   part_acc@0.05 (and the refined row's) within ``TOL_3D_ASSETS`` of the JAX
   package's CPU run in bf16 (``JAX_CPU_3D_ASSETS``); gauge-aligned rows and
   the TPU's figures printed, ungated;
16. 3D training with the other encoders and split message passing, the ninth
   main path, through ``run_3d``: ``pointnet`` at full width (N = 20, batch
   16 of 1000 points, from ``weights/pointnet_pose3d.npz``), 3 steps with an
   evaluation and checkpoint, a resume to 4; one step each of
   ``pointnet_inv`` (Dh 136), ``pointnet_plus`` (Dh 40), ``vnn`` (Dh 271)
   and ``vn_dgcnn`` with ``--equiv_inv_mp 1`` (Dh 136, keys and values from
   the invariant stream). Each first holds its f32 loss on the card to the
   CPU's on the same seeded weights and draws; ``vnn`` and the split message
   passing hold their f32 gradients with the kernels to those with plain
   attention. Every step has each kernel once a layer per denoiser pass, one
   layer on the CUDA cores, finite losses and nonzero gradients.

``python3 chip_smoke.py --profile train-device`` profiles one step of the
recipe instead, ``--profile eval3d`` one 3D held-out call of 16 objects,
``--profile train3d`` one 3D train step.

The last three lines are the nvidia-smi line, a JSON object describing the
kernels, and ``{"ok": true, "device": {...}}``. Any failure raises, and the
script exits non-zero without printing the last line.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "weights" / "diffusion2d_rot30" / "config.json"
DATA = ROOT / "weights" / "diffusion2d_rot30" / "data.json"  # the flagship's data recipe
ASSET = ROOT / "diffassemble_tpu_torch" / "assets" / "diffusion2d_rot30_ema32000.npz"
ENCODER_INIT = ROOT / "weights" / "efficientnet_b0_pose30hf.npz"  # the flagship's encoder_init
MIXED_DATA = ROOT / "weights" / "diffusion2d_rot_ms" / "data.json"  # the mixed-size recipe (hw 6/8/10/12)
MIXED_CONFIG = ROOT / "weights" / "diffusion2d_rot_ms" / "config.json"  # its model: resnet18equiv, flagship widths
MIXED_BATCH = 16  # its run's batch (scripts/tpu_queue_r5e.sh:83-88), no EMA
# the other trained 2D checkpoints' figures on the TPU (each checkpoint's metrics file: rot_ms at step 7000,
# discrete_rot6 at step 6000); the card's piece_acc must lie within PIECE_ACC_TOL of the TPU's
TPU_2D = {"diffusion2d_rot_ms": {"overall__piece_acc": 0.9996744794771075, "overall_acc": 0.984375},
          "diffusion2d_discrete_rot6": {"overall__piece_acc": 1.0, "overall_acc": 1.0}}
# the discrete-rotation model trained through the rotation CLI: weights/diffusion2d_discrete_rot6's config
# (scripts/tpu_train_variants.py's make_model; committed in its asset, as the checkpoint's directory stays
# out of the chip copy) at its 6x6 size and batch of 32, from seeded weights; 2 steps, then a resume to step 3
DISCRETE_FLAGS = [
    "-dataset", "synthetic", "-puzzle_sizes", "6", "--degree", "60%", "--unique_graph", "true", "-batch_size", "32",
    "--discrete", "true", "--cold_diffusion", "true", "--loss_type", "vb", "--backbone", "resnet18equiv",
    "--aux_loss_weight", "0.1", "--warmup_steps", "200", "--compute_dtype", "bfloat16", "--device", "cuda",
]
DISCRETE_STEPS, DISCRETE_RESUME_TO = 2, 3
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, NVIDIA H100 SXM data sheet
H100_F32_FLOPS = 67e12  # non-tensor-core f32 peak
H100_BYTES_PER_S = 3.35e12
N_NODES = 908  # 900 pieces + 8 virtual nodes
HEADS = 8
STEP_LAUNCHES = ((32, 3), (144, 1))  # (head width, launches) per denoiser step or train step
REQUESTS = 3
TRAIN_BATCH = 8
TRAIN_STEPS, RESUME_STEPS = 3, 2
# the flagship's training flags on the rotation CLI (weights/diffusion2d_rot30/config.json
# and data.json; batch 8 as the 900-piece recipe), with seeded weights: the recipe
# phase trains from the flagship's encoder_init (ENCODER_INIT), this phase does not
TRAIN_FLAGS = [
    "--backbone", "efficientnet_b0", "-dataset", "synthetic", "-puzzle_sizes", "30",
    "--degree", "10%", "--unique_graph", "true", "-batch_size", str(TRAIN_BATCH),
    "--aux_loss_weight", "0.1", "--warmup_steps", "500", "--compute_dtype", "bfloat16",
    "--device", "cuda",
]
CUDA_CORE_SOURCES = {
    "masked_attention_fwd": "diffassemble_tpu_torch/csrc/masked_attention_fwd.cu",
    "masked_attention_bwd_dq": "diffassemble_tpu_torch/csrc/masked_attention_bwd.cu",
    "masked_attention_bwd_dkv": "diffassemble_tpu_torch/csrc/masked_attention_bwd.cu",
}
# each kernel's source on the main paths: the tensor-core route (bf16 at Dh 32 and 144)
KERNEL_SOURCES = {
    "masked_attention_fwd": "diffassemble_tpu_torch/csrc/masked_attention_fwd_tc.cu",
    "masked_attention_bwd_dq": "diffassemble_tpu_torch/csrc/masked_attention_bwd_tc.cu",
    "masked_attention_bwd_dkv": "diffassemble_tpu_torch/csrc/masked_attention_bwd_tc.cu",
}
# bench.py's held-out protocol: 64 puzzles of 30x30, sampled 32 to a call
EVAL_TOTAL, EVAL_N = 64, 32
# the target: piece_acc of the same checkpoint and protocol on a TPU v5 lite
# (BENCH_r05.json); the card's must lie within PIECE_ACC_TOL of it
TPU_PIECE_ACC, PIECE_ACC_TOL = 0.9763, 0.01
EXPANDER_TRIES = 5  # expander_mask's max_num_iters: the candidate graphs a seed draws
FWD_BLOCK_ROWS = (64, 32, 16)  # the tensor-core forward's query blocks, timed in turn
MAIN_HEAD_DIMS = (32, 144)
# the recipe CLI (cli/train_device.py) cut for time: corpora of 16 and 8
# puzzles, 6 steps with an evaluation every 3, then a resume to 8; the mixed
# corpus 3 steps; EMA on as the flagship's run had it
RECIPE_TRAIN_N, RECIPE_EVAL_N, RECIPE_STEPS, RECIPE_EVAL_EVERY, RECIPE_RESUME_TO = 16, 8, 6, 3, 8
MIXED_STEPS, MIXED_RESUME_TO = 3, 4
EMA_DECAY = 0.999
# widths off the tensor-core route: 20 is no multiple of 8; the 3D family's last layers (feature
# width + 64 over 8 heads) are 24 (pointnet), 40 (pointnet_plus), 104 (vn_dgcnn), 136 (pointnet_inv,
# and vn_dgcnn_equiv_inv under split message passing), 264 (vn_dgcnn_rich) and 271 (vnn: odd, so
# each bf16 head starts 2 bytes off a 4-byte boundary)
OTHER_HEAD_DIMS = (20, 24, 40, 104, 136, 264, 271)
# the 3D held-out protocol: scripts/tpu_eval_3d.py on weights/diffusion3d_easy at step 12000
# (64 synthetic objects in calls of 16, 512 points, 2-8 parts, ratio 10), its params committed
# converted with the config and the protocol's arguments
ASSET_3D = ROOT / "diffassemble_tpu_torch" / "assets" / "diffusion3d_easy12000.npz"
N_PARTS_3D = 318
# the JAX package's own run of the same protocol on a CPU (tests/torch_assets.py:jax_reference_3d),
# in the checkpoint's bf16 and in f32; the gate holds the card's bf16 run to the bf16 one
JAX_CPU_3D = {
    "bfloat16": {"rmse_t": 0.10137863975251094, "rmse_r": 31.713459108024836, "gd_r": 0.8803411722183228,
                 "part_acc@0.01": 0.025157232704402517, "part_acc@0.05": 0.4716981132075472},
    "float32": {"rmse_t": 0.10094427071453538, "rmse_r": 32.21889664232731, "gd_r": 0.8804664611816406,
                "part_acc@0.01": 0.0220125786163522, "part_acc@0.05": 0.4748427672955975},
}
# tolerances, fixed before the first card run (PERF.md §6): wider than the CPU's own bf16-to-f32
# spread (0.00043, 0.51°, 0.0031) and than the TPU-to-CPU move (0.0003, 0.6°, 2 parts of 318)
TOL_3D = {"rmse_t": 0.005, "rmse_r": 2.0, "part_acc@0.05": 0.03}
# the TPU's figures (results/diagnostics/eval3d_easy12k.json), printed beside the card's, ungated
TPU_3D = {"rmse_t": 0.10167788807302713, "rmse_r": 32.314783960580826, "gd_r": 0.8866940140724182,
          "part_acc@0.01": 0.0220125786163522, "part_acc@0.05": 0.46855345911949686}

# the 3D training run: weights/diffusion3d_easy's flags (scripts/tpu_queue_r5e.sh:150-158 with NPTS=512
# and WBOOST=3 at :121) at full width, its corpus cut to 48 training and 16 held-out objects; 4 steps
# with an evaluation at step 4, then a resume to step 6
TRAIN3D_FLAGS = [
    "--dataset", "synthetic", "--backbone", "vn_dgcnn_rich", "--batch_size", "16", "--num_points", "512",
    "--max_num_part", "8", "--min_num_part", "2", "--rel_pose_weight", "0.5", "--rel_condition", "1",
    "--contact_thresh", "0.1", "--aux_pose_weight", "0.5", "--rot_pt_l2_weight", "1.0", "--wall_detail", "0.08",
    "--wall_boost", "3", "--synthetic_canonical", "0.9", "--encoder_init", "weights/vn_dgcnn_rich_rel3d_512.npz",
    "--train_n", "48", "--test_n", "16", "--device", "cuda",
]
TRAIN3D_STEPS, TRAIN3D_RESUME_TO = 4, 6
LOSS3D_SEED = 0  # the numpy seed of the trained-weights loss check's draws

# the JAX package's training loss dict of the same trained weights on the CPU, on the 3D run's first
# batch with the check's draws (tests/torch_assets.py:jax_loss_3d); the card's must lie within
# TOL_LOSS_3D (relative: each term, the total) of the same type's, fixed before the first card run
# from the CPU's port-vs-JAX spread (PERF.md §6): bf16 4.5% on a term, 0.93% on the total; f32
# 2.1e-4 and 1.2e-5
JAX_CPU_LOSS_3D = {
    "bfloat16": {"trans_loss": 0.004710462410002947, "rot_pt_cd_loss": 0.010998780839145184,
                 "transform_pt_cd_loss": 0.007798135746270418, "rot_loss": 0.006374541204422712,
                 "rot_pt_l2_loss": 0.013815953396260738, "aux_pose_loss": 0.024139009416103363,
                 "rel_rot_loss": 0.18721681833267212, "rel_off_loss": 0.18264563381671906,
                 "rel_conf_loss": 0.4371764063835144, "loss": 0.5133715867996216},
    "float32": {"trans_loss": 0.004836279898881912, "rot_pt_cd_loss": 0.010646283626556396,
                "transform_pt_cd_loss": 0.007700525224208832, "rot_loss": 0.005979315843433142,
                "rot_pt_l2_loss": 0.013255426660180092, "aux_pose_loss": 0.02350827120244503,
                "rel_rot_loss": 0.1891193836927414, "rel_off_loss": 0.1852894127368927,
                "rel_conf_loss": 0.4237699508666992, "loss": 0.507136344909668},
}
TOL_LOSS_3D = {"bfloat16": (0.1, 0.02), "float32": (2e-3, 2e-4)}

# the rest of the 3D family. The other trained checkpoints, each committed converted with its
# protocol (tests/torch_assets.py:ASSETS_3D): n_parts of the protocol, the JAX package's own run of
# it on a CPU by ratio and type (tests/torch_assets.py:jax_reference_3d), the gated keys'
# tolerances, fixed before the first card run from the CPU's port-vs-JAX spread (PERF.md §6), and
# the TPU's figures where the repo has them, printed beside the card's, ungated
MORE_ASSETS_3D = ("diffusion3d_relpose", "diffusion3d_wallsurf", "diffusion3d_vndgcnn")
N_PARTS_3D_ASSETS = {"diffusion3d_easy": N_PARTS_3D, "diffusion3d_relpose": 318, "diffusion3d_wallsurf": 318,
                     "diffusion3d_vndgcnn": 318}
JAX_CPU_3D_ASSETS = {
    "diffusion3d_easy": {10: JAX_CPU_3D},
    "diffusion3d_relpose": {
        10: {
            "bfloat16": {"rmse_t": 0.21026736265048385, "rmse_r": 55.62228138744831, "gd_r": 1.491101861000061,
                "part_acc@0.01": 0.0, "part_acc@0.05": 0.13522012578616352, "gauge gd_r": 1.2896068096160889,
                "gauge rmse_t": 0.26787575182970613},
            "float32": {"rmse_t": 0.2097444036626257, "rmse_r": 56.257983818650246, "gd_r": 1.4934895038604736,
                "part_acc@0.01": 0.0, "part_acc@0.05": 0.1289308176100629, "gauge gd_r": 1.2921489477157593,
                "gauge rmse_t": 0.2658515727962367},
        },
    },
    "diffusion3d_wallsurf": {
        10: {
            "bfloat16": {"rmse_t": 0.10488867183448747, "rmse_r": 33.67202050238848, "gd_r": 0.9216157793998718,
                "part_acc@0.01": 0.018867924528301886, "part_acc@0.05": 0.4748427672955975,
                "gauge gd_r": 0.8661601543426514, "gauge rmse_t": 0.1391138373874128,
                "refined rmse_t": 0.12798721325816587, "refined rmse_r": 33.59212777763605,
                "refined gd_r": 0.9173377752304077, "refined part_acc@0.05": 0.3867924528301887},
            "float32": {"rmse_t": 0.10393720353022218, "rmse_r": 33.61207918822765, "gd_r": 0.9237696528434753,
                "part_acc@0.01": 0.018867924528301886, "part_acc@0.05": 0.4748427672955975,
                "gauge gd_r": 0.871688961982727, "gauge rmse_t": 0.13687697605928406,
                "refined rmse_t": 0.12892981054028496, "refined rmse_r": 33.58056973665953,
                "refined gd_r": 0.915383517742157, "refined part_acc@0.05": 0.389937106918239},
        },
    },
    "diffusion3d_vndgcnn": {
        10: {
            "bfloat16": {"rmse_t": 0.42344477551523596, "rmse_r": 76.63444077968597, "gd_r": 1.9368574619293213,
                "part_acc@0.01": 0.0, "part_acc@0.05": 0.0, "gauge gd_r": 1.500832200050354,
                "gauge rmse_t": 0.45080935047008097},
            "float32": {"rmse_t": 0.4194669909775257, "rmse_r": 76.15445947647095, "gd_r": 1.9357287883758545,
                "part_acc@0.01": 0.0, "part_acc@0.05": 0.0031446540880503146, "gauge gd_r": 1.500742793083191,
                "gauge rmse_t": 0.44835506309755147},
        },
        2: {
            "bfloat16": {"rmse_t": 0.4235719779971987, "rmse_r": 76.58183288574219, "gd_r": 1.937819242477417,
                "part_acc@0.01": 0.0, "part_acc@0.05": 0.0, "gauge gd_r": 1.5026315450668335,
                "gauge rmse_t": 0.4492489465046674},
        },
    },
}
TOL_3D_ASSETS = {
    "diffusion3d_easy": TOL_3D,
    # the raw rows: the easy checkpoint's (the CPU's port-vs-JAX spread in bf16 is at most 0.00036,
    # 0.48° and 3 parts of 318); the refined row: wider, the ICP's nearest neighbours and trimming
    # turn rounding into other matches (the CPU's spread 0.0020, 0.66°, 10 parts of 318)
    "diffusion3d_relpose": TOL_3D,
    "diffusion3d_wallsurf": {**TOL_3D, "refined rmse_t": 0.01, "refined rmse_r": 3.0, "refined part_acc@0.05": 0.07},
    "diffusion3d_vndgcnn": TOL_3D,
}
TPU_3D_ASSETS = {
    "diffusion3d_easy": {10: TPU_3D},
    # results/diagnostics/eval3d_vndgcnn.json (step 3000)
    "diffusion3d_vndgcnn": {10: {"rmse_t": 0.42499070800840855, "rmse_r": 76.61813676357269,
                                 "gd_r": 1.9512873888015747, "part_acc@0.01": 0.0, "part_acc@0.05": 0.0},
                            2: {"rmse_t": 0.42527247057296336, "rmse_r": 76.57260298728943,
                                "gd_r": 1.9512617588043213, "part_acc@0.01": 0.0, "part_acc@0.05": 0.0}},
    # results/diagnostics/eval3d_relpose_fix.json: a hint only, its ckpt names a run directory at step 12000
    "diffusion3d_relpose": {10: {"rmse_t": 0.21022925659781322, "rmse_r": 55.941426143050194, "gd_r": 1.4961600303649902,
                                 "part_acc@0.01": 0.0, "part_acc@0.05": 0.1320754716981132,
                                 "gauge gd_r": 1.2949351072311401, "gauge rmse_t": 0.26829985121730715}},
}
# 3D training with the other encoders: the configuration of results/quality-3d-pointnet/config.json
# (pointnet, N = 20, bf16) at the CLI's 1000 points and batch 16, from the pose-pretrained encoder
# weights/pointnet_pose3d.npz, its corpus cut to 48 training and 16 held-out objects: 3 steps with an
# evaluation at step 3, then a resume to step 4
TRAIN3D_POINTNET_FLAGS = [
    "--dataset", "synthetic", "--backbone", "pointnet", "--batch_size", "16", "--num_points", "1000",
    "--max_num_part", "20", "--min_num_part", "2", "--compute_dtype", "bfloat16",
    "--encoder_init", "weights/pointnet_pose3d.npz", "--train_n", "48", "--test_n", "16", "--device", "cuda",
]
TRAIN3D_POINTNET_STEPS, TRAIN3D_POINTNET_RESUME_TO = 3, 4
_ONE_STEP = ["--train_n", "16", "--test_n", "16", "--device", "cuda"]
_N20 = ["--dataset", "synthetic", "--batch_size", "16", "--num_points", "1000", "--max_num_part", "20",
        "--min_num_part", "2", "--compute_dtype", "bfloat16", *_ONE_STEP]
# one step each, seeded weights: the other encoders at the same widths, and split message passing
# (vn_dgcnn becomes vn_dgcnn_equiv_inv, [equiv 768 ‖ inv 256]) on the easy run's corpus and losses
TRAIN3D_ONE_STEP = {
    "pointnet_inv": ["--backbone", "pointnet_inv", *_N20],
    "pointnet_plus": ["--backbone", "pointnet_plus", *_N20],
    "vnn": ["--backbone", "vnn", *_N20],
    "vn_dgcnn_equiv_inv_mp": [
        "--dataset", "synthetic", "--backbone", "vn_dgcnn", "--equiv_inv_mp", "1", "--batch_size", "16",
        "--num_points", "512", "--max_num_part", "8", "--min_num_part", "2", "--aux_pose_weight", "0.5",
        "--rot_pt_l2_weight", "1.0", "--wall_detail", "0.08", "--wall_boost", "3", "--synthetic_canonical", "0.9",
        "--compute_dtype", "bfloat16", *_ONE_STEP],
}
GRADIENT_PARITY_3D = ("vnn", "vn_dgcnn_equiv_inv_mp")  # kernel vs plain-attention gradients: Dh 271; 136 dual
LOSS_CPU_OBJECTS = 2  # objects of the first batch in the f32 card-vs-CPU loss check

_T0 = time.perf_counter()


def phase(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:8.2f} s] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` calls.

    A spin kernel (~50 ms) runs first, so that the host has queued all the
    calls before the first one starts: the events then time the calls back to
    back on the device, not the host's enqueue rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(kernel: str, b: int, n: int, h: int, dh: int, elem_bytes: int,
             pairs: int | None = None) -> tuple[float, str]:
    """Least time on an H100 for one launch: the larger of its operations over
    the peak rate for the type and the bytes it must move (each input read
    once, each output written once) over the memory rate.

    forward: S and O·V, 4·H·Dh per attended (query, key) pair; reads q, k, v
    and the mask, writes O, L.
    dQ: S, dP and dQ, 6·H·Dh a pair; reads q, k, v, dO, L, Δ and the mask, writes dQ.
    dK/dV: S, dP, dV and dK, 8·H·Dh a pair; reads q, k, v, dO, L, Δ and the mask,
    writes dK and dV.
    ``pairs`` is the mask's attended pairs (default: all B·N², fully connected)."""
    tensor = b * n * h * dh * elem_bytes  # one (B, N, H, Dh) tensor
    row = 4.0 * b * h * n  # one (B, H, N) f32 tensor
    mask = b * n * n
    pairs = mask if pairs is None else pairs
    flops, nbytes = {
        "masked_attention_fwd": (4, 4 * tensor + row + mask),
        "masked_attention_bwd_dq": (6, 5 * tensor + 2 * row + mask),
        "masked_attention_bwd_dkv": (8, 6 * tensor + 2 * row + mask),
    }[kernel]
    t_ops = flops * h * pairs * dh / (H100_BF16_FLOPS if elem_bytes == 2 else H100_F32_FLOPS)
    t_bytes = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def environment() -> tuple[str, str, int]:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    # f32 comparisons on the card run in full f32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    phase(f"environment: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"device {name} | count {count}")
    return smi, name, count


def build() -> None:
    from diffassemble_tpu_torch.ops import cuda_attention

    lib = cuda_attention.load_library()
    source, spills = "", []
    for line in lib.compiler_log.splitlines():
        if line.startswith("=="):
            source = line
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
        if "_tc." in source and "spill" in line and not line.strip().endswith("0 bytes spill stores, 0 bytes spill loads"):
            spills.append(line.strip())
    phase(f"build: {', '.join(p.name for p in lib.paths.values())} in {lib.build_seconds:.2f} s")
    if spills:
        raise AssertionError(f"a tensor-core kernel spills registers: {spills}")


def reset_counts() -> None:
    from diffassemble_tpu_torch.ops import cuda_attention

    cuda_attention.reset_launch_counts()


def read_counts() -> dict[str, int]:
    from diffassemble_tpu_torch.ops import cuda_attention

    return {kern.__name__: kern.launches for kern in cuda_attention.KERNELS}


def read_routes() -> dict[str, dict[str, int]]:
    from diffassemble_tpu_torch.ops import cuda_attention

    return {kern.__name__: dict(kern.launches_by_route) for kern in cuda_attention.KERNELS}


def routes_since(before: dict[str, dict[str, int]]) -> dict[str, dict[str, int]]:
    return {k: {r: n - before[k][r] for r, n in by_route.items()} for k, by_route in read_routes().items()}


def committed_adj():
    """(900, 900) bool: the held-out protocol's expander, committed beside the
    flagship's converted weights."""
    import numpy as np

    n = 900
    with np.load(ASSET) as z:
        bits = z["heldout_adj_bits"]
    return np.unpackbits(bits, count=n * n).reshape(n, n).astype(bool)


def _masks(torch, np):
    """(label, mask (B, N, N) bool on the card) for each checked topology: the
    main paths' own (the 10% expander plus 8 virtual nodes, at B = 1 as a
    request runs it and shared across B = 8 as a train step runs it), then
    padded nodes and empty rows, fully connected, a ragged N = 200, and the
    held-out evaluation's (the committed expander plus 8 virtual nodes,
    shared across B = 32)."""
    from diffassemble_tpu_torch.data.expander import expander_mask
    from diffassemble_tpu_torch.ops.attention import (
        build_adjacency_mask,
        extend_mask_with_virtual_nodes,
    )

    rng = np.random.default_rng(0)
    topo = torch.as_tensor(expander_mask(900, "10%", rng))
    padded = torch.ones((2, 900), dtype=torch.bool)
    padded[1, 850:] = False  # 50 padded pieces: their rows and columns are empty
    out = []
    for label, node_mask in (("expander10%+8virt, B=1 (serving)", torch.ones((1, 900), dtype=torch.bool)),
                             (f"expander10%+8virt, B={TRAIN_BATCH} (training)",
                              torch.ones((TRAIN_BATCH, 900), dtype=torch.bool)),
                             ("expander10%+8virt, 50 padded", padded)):
        adj, _ = extend_mask_with_virtual_nodes(build_adjacency_mask(topo, node_mask), node_mask, 8)
        if label.endswith("padded"):
            adj[0, 700:720] = False  # plus rows with no edges at all in the first graph
        out.append((label, adj))
    out.append(("fully connected", torch.ones((2, N_NODES, N_NODES), dtype=torch.bool)))
    small_valid = torch.ones((2, 200), dtype=torch.bool)
    small_valid[1, 150:] = False
    small = build_adjacency_mask(torch.as_tensor(rng.random((2, 200, 200)) < 0.3), small_valid)
    out.append(("N=200, random 30%, 50 padded", small))
    eval_valid = torch.ones((EVAL_N, 900), dtype=torch.bool)
    adj, _ = extend_mask_with_virtual_nodes(build_adjacency_mask(torch.as_tensor(committed_adj()), eval_valid),
                                            eval_valid, 8)
    out.append((f"committed expander+8virt, B={EVAL_N} (eval)", adj))
    return [(label, m.cuda().contiguous()) for label, m in out]


def _check_kernels(label: str, mask, dh: int, dtype, gen, max_err: dict[str, float],
                   misaligned: bool = False, backward: bool = True) -> None:
    """The three kernels (the forward alone without ``backward``) against
    their plain versions on one mask, width and type, on the route these call
    for: the tensor cores for bf16 at the main paths' widths, else (and for
    ``misaligned`` inputs, 2 bytes off a 16-byte boundary) the CUDA cores;
    raises on a disagreement or another route. Updates ``max_err`` per
    kernel."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    b, n, _ = mask.shape
    empty = ~mask.any(-1)  # (B, N) query rows with no edges
    unattended = ~mask.any(-2)  # (B, N) keys no query attends
    q, k, v, dout = (torch.randn((b, n, HEADS, dh), generator=gen, device="cuda").to(dtype) for _ in range(4))
    if misaligned:
        q, k, v, dout = (_misaligned(t) for t in (q, k, v, dout))
        label = f"{label}, misaligned"
    want = ("tensor_cores" if dtype == torch.bfloat16 and dh in MAIN_HEAD_DIMS and not misaligned
            else "cuda_cores")
    fwd_route = ca.route("masked_attention_fwd", q, k, v, mask)
    if fwd_route != want:
        raise AssertionError(f"forward route {fwd_route} at Dh={dh} {dtype}, expected {want}")
    o, lse = ca.masked_attention_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    o_p, lse_p = ca.masked_attention_fwd_plain(q, k, v, mask)
    of, opf = o.float(), o_p.float()
    vmax = v.float().abs().max().item()
    if dtype == torch.float32:
        # f32: sums of ~N products in another order
        tol = 1e-5 * opf.abs() + 1e-5 * vmax
    else:
        # bf16: one ulp of the output (2^-7 relative) plus the plain
        # version's rounding of each probability to bf16 (2^-9 of max|v|)
        tol = 2.0**-7 * opf.abs() + 2.0**-9 * vmax
    err = (of - opf).abs()
    nonempty = ~empty[:, None, :].expand(b, HEADS, n)
    lse_err = (lse - lse_p).abs()[nonempty]
    ok = (
        bool(torch.isfinite(of).all()) and bool(torch.isfinite(lse).all())
        and bool((err <= tol).all())
        and bool((lse_err <= 1e-5 * (1 + lse_p.abs()[nonempty])).all())
        and bool((of[empty] == 0).all())
        and torch.equal(lse[~nonempty], lse_p[~nonempty])
    )
    max_err["masked_attention_fwd"] = max(max_err["masked_attention_fwd"], err.max().item())
    phase(f"fwd vs plain: {label:34s} B={b} N={n} Dh={dh:3d} {str(dtype)[6:]:8s} {fwd_route:12s} "
          f"max|dO|={err.max().item():.3e} worst err/tol {(err / tol).max().item():.3f} "
          f"max|dL|={lse_err.max().item():.3e} "
          f"empty rows={int(empty.sum())} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"forward kernel disagrees with its plain version: {label} Dh={dh} {dtype}")
    if not backward:
        return

    # the backward kernels, from this forward's O and L
    delta = ca.attention_delta(dout, o)
    args = (q, k, v, mask, dout, lse, delta)
    routes = {ca.route(name, *args) for name in ("masked_attention_bwd_dq", "masked_attention_bwd_dkv")}
    if routes != {want}:
        raise AssertionError(f"backward routes {routes} at Dh={dh} {dtype}, expected {want}")
    dq = ca.masked_attention_bwd_dq(*args)
    dk, dv = ca.masked_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    dq_p = ca.masked_attention_bwd_dq_plain(*args)
    dk_p, dv_p = ca.masked_attention_bwd_dkv_plain(*args)
    # f32: 1e-5 relative plus 1e-5 of max|ref| (sums of ~N products in
    # another order); bf16: one bf16 ulp (2^-7 relative) plus 1e-4 of
    # max|ref| (the same f32 sums, then rounded once to bf16)
    rel, floor = (1e-5, 1e-5) if dtype == torch.float32 else (2.0**-7, 1e-4)
    errs, worst, ok = {}, 0.0, True
    for key, got, ref in (("dQ", dq, dq_p), ("dK", dk, dk_p), ("dV", dv, dv_p)):
        gf, rf = got.float(), ref.float()
        e = (gf - rf).abs()
        t = rel * rf.abs() + floor * rf.abs().max()
        errs[key] = e.max().item()
        worst = max(worst, (e / t).max().item())
        ok &= bool(torch.isfinite(gf).all()) and got.dtype == dtype
        ok &= bool((e <= t).all())
    zeros = (bool((dq[empty] == 0).all()) and bool((dk[unattended] == 0).all())
             and bool((dv[unattended] == 0).all()))
    max_err["masked_attention_bwd_dq"] = max(max_err["masked_attention_bwd_dq"], errs["dQ"])
    max_err["masked_attention_bwd_dkv"] = max(max_err["masked_attention_bwd_dkv"], errs["dK"], errs["dV"])
    phase(f"bwd vs plain: {label:34s} B={b} N={n} Dh={dh:3d} {str(dtype)[6:]:8s} {want:12s} "
          f"max|ddQ|={errs['dQ']:.3e} max|ddK|={errs['dK']:.3e} max|ddV|={errs['dV']:.3e} "
          f"worst err/tol {worst:.3f} unattended keys={int(unattended.sum())} exact zeros {zeros} "
          f"{'ok' if ok and zeros else 'FAIL'}")
    if not (ok and zeros):
        raise AssertionError(f"backward kernels disagree with their plain versions: {label} Dh={dh} {dtype}")


def kernels_vs_plain() -> dict[str, float]:
    """Each kernel against its plain version on the same inputs: every mask
    at the main paths' widths, then the other widths on two masks; a head
    wider than the kernels take must raise. Returns the largest
    |kernel − plain| of each kernel."""
    import numpy as np
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = dict.fromkeys(KERNEL_SOURCES, 0.0)
    masks = _masks(torch, np)
    for label, mask in masks:
        for dh in MAIN_HEAD_DIMS:
            for dtype in (torch.bfloat16, torch.float32):
                _check_kernels(label, mask, dh, dtype, gen, max_err)
    for dh in MAIN_HEAD_DIMS:  # the CUDA-core route in bf16 at the main paths' widths
        _check_kernels(masks[0][0], masks[0][1], dh, torch.bfloat16, gen, max_err, misaligned=True)
    for label, mask in (masks[0], masks[2]):  # B = 1 expander; padded nodes and empty rows
        for dh in OTHER_HEAD_DIMS:
            for dtype in (torch.bfloat16, torch.float32):
                _check_kernels(label, mask, dh, dtype, gen, max_err)
    wide = torch.zeros((1, 16, HEADS, ca.MAX_HEAD_DIM + 8), device="cuda")
    try:
        ca.masked_attention_fwd(wide, wide, wide, torch.ones((1, 16, 16), dtype=torch.bool, device="cuda"))
    except ValueError as e:
        phase(f"Dh={wide.shape[-1]} raises: {e}")
    else:
        raise AssertionError(f"a head of {wide.shape[-1]} columns did not raise")
    return max_err


def _misaligned(x):
    """A contiguous copy of ``x`` starting 2 bytes past a 16-byte boundary:
    the kernels take the CUDA-core route for it."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _fwd_block_rows_sweep(q, k, v, mask, o, lse) -> list[dict]:
    """The tensor-core forward at each query block of ``FWD_BLOCK_ROWS`` on
    the same inputs, through the C entry point that takes the block's rows
    (uncounted): each must give the wrapper's O and L bit for bit (a warp's
    16 rows are computed alike in any block), then is timed."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    lib = ca.load_library()
    fn = lib.fn("masked_attention_fwd_tc_rows")
    b, n, h, dh = q.shape
    chosen = lib.fn("masked_attention_fwd_tc_block_rows")(b, n, h, dh)
    stream = torch.cuda.current_stream().cuda_stream
    out = []
    for rows in FWD_BLOCK_ROWS:
        o2, lse2 = torch.empty_like(o), torch.empty_like(lse)

        def call():
            rc = fn(*(t.data_ptr() for t in (q, k, v, mask, o2, lse2)), b, n, h, dh, 1, 1.0 / math.sqrt(dh),
                    rows, stream)
            if rc != 0:
                raise RuntimeError(f"masked_attention_fwd_tc_rows({rows}) failed: CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        if not (torch.equal(o2, o) and torch.equal(lse2, lse)):
            raise AssertionError(f"the forward with {rows}-row blocks differs from the launch's own (B={b} Dh={dh})")
        ms = cuda_ms(call)
        blocks = -(-n // rows) * h * b
        out.append({"b": b, "dh": dh, "block_rows": rows, "blocks": blocks, "chosen": rows == chosen, "ms": ms})
        phase(f"timing fwd, tensor cores, {rows:2d}-row query blocks ({blocks:4d} blocks) B={b} Dh={dh:3d}: "
              f"{ms:.4f} ms{' (the launch chooses these)' if rows == chosen else ''}")
    if chosen not in FWD_BLOCK_ROWS:
        raise AssertionError(f"the forward chose {chosen}-row blocks")
    return out


def timing() -> tuple[list[dict], list[dict]]:
    """Kernel, plain and library times at the serving (B = 1, forward),
    training (B = 8, all three) and held-out evaluation (B = 32, forward)
    shapes, bf16, fully connected mask. The library's backward is one SDPA
    backward, which computes dQ, dK and dV together: both backward rows carry
    that one time, to be set against the sum of the two kernels' times. At
    the main paths' widths the same kernels on the CUDA-core route in bf16
    are timed beside the tensor-core route, and the tensor-core forward at
    each query block size; at B = 8 the three kernels at the widths off the
    main paths. Rows off the main paths have
    ``main_path`` false. Returns the rows and the block-size sweep."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, sweep = [], []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b in (1, TRAIN_BATCH, EVAL_N):
        mask = torch.ones((b, N_NODES, N_NODES), dtype=torch.bool, device="cuda")
        shapes = [(dh, count, True) for dh, count in STEP_LAUNCHES]
        if b == TRAIN_BATCH:
            shapes += [(dh, 0, False) for dh in OTHER_HEAD_DIMS]
        for dh, count, main in shapes:
            q, k, v, dout = (torch.randn((b, N_NODES, HEADS, dh), generator=gen, device="cuda")
                             .to(torch.bfloat16) for _ in range(4))
            o, lse = ca.masked_attention_fwd(q, k, v, mask)
            delta = ca.attention_delta(dout, o)
            # the library call: SDPA with the boolean mask, in its (B, H, N, Dh) layout
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
            dout_t = dout.transpose(1, 2).contiguous()
            sdpa_mask = mask[:, None]
            with torch.no_grad():
                lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=sdpa_mask))
            out_t = sdpa(qt, kt, vt, attn_mask=sdpa_mask)
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(out_t, (qt, kt, vt), dout_t, retain_graph=True))
            args = (q, k, v, mask, dout, lse, delta)
            cases = [("masked_attention_fwd", lambda: ca.masked_attention_fwd(q, k, v, mask),
                      lambda: ca.masked_attention_fwd_plain(q, k, v, mask), lib_fwd)]
            if b == TRAIN_BATCH:
                cases += [
                    ("masked_attention_bwd_dq", lambda: ca.masked_attention_bwd_dq(*args),
                     lambda: ca.masked_attention_bwd_dq_plain(*args), lib_bwd),
                    ("masked_attention_bwd_dkv", lambda: ca.masked_attention_bwd_dkv(*args),
                     lambda: ca.masked_attention_bwd_dkv_plain(*args), lib_bwd),
                ]
            here = []
            for kernel, fn, plain, library_ms in cases:
                ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
                bound, bound_by = bound_ms(kernel, b, N_NODES, HEADS, dh, 2)
                route = ca.route(kernel, *args)
                here.append({"kernel": kernel, "b": b, "n": N_NODES, "dh": dh, "route": route, "main_path": main,
                             "launches_per_step": count, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                             "bound_ms": bound, "bound_by": bound_by})
                phase(f"timing {kernel:25s} B={b} N={N_NODES} H={HEADS} Dh={dh:3d} bf16 {route:12s}: kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
                      f"bound {bound:.5f} ms ({bound_by})")
            if main:
                # the CUDA-core route on the same inputs, 2 bytes off a 16-byte boundary
                mq, mk, mv, mdo = (_misaligned(t) for t in (q, k, v, dout))
                margs = (mq, mk, mv, mask, mdo, lse, delta)
                cc = {}
                cc_cases = [("masked_attention_fwd", lambda: ca.masked_attention_fwd(mq, mk, mv, mask))]
                if b == TRAIN_BATCH:
                    cc_cases += [("masked_attention_bwd_dq", lambda: ca.masked_attention_bwd_dq(*margs)),
                                 ("masked_attention_bwd_dkv", lambda: ca.masked_attention_bwd_dkv(*margs))]
                for kernel, fn in cc_cases:
                    assert ca.route(kernel, *margs) == "cuda_cores"
                    ref = next(r for r in here if r["kernel"] == kernel)
                    cc[kernel] = cuda_ms(fn)
                    here.append({**ref, "route": "cuda_cores", "main_path": False, "launches_per_step": 0,
                                 "ms": cc[kernel]})
                tc_fwd = here[0]["ms"]
                phase(f"timing forward, CUDA cores    B={b} N={N_NODES} H={HEADS} Dh={dh:3d} bf16: "
                      f"{cc['masked_attention_fwd']:.4f} ms; the tensor-core forward is "
                      f"{cc['masked_attention_fwd'] / tc_fwd:.2f}x faster, {tc_fwd / lib_fwd:.2f}x SDPA's time")
                if b == TRAIN_BATCH:
                    tc_pair = here[1]["ms"] + here[2]["ms"]
                    cc_pair = cc["masked_attention_bwd_dq"] + cc["masked_attention_bwd_dkv"]
                    phase(f"timing backward pair          B={b} N={N_NODES} H={HEADS} Dh={dh:3d} bf16: dQ + dK/dV "
                          f"{tc_pair:.4f} ms on the tensor cores, {cc_pair:.4f} ms on the CUDA cores, against one "
                          f"SDPA backward (dQ, dK, dV) {lib_bwd:.4f} ms: {tc_pair / lib_bwd:.2f}x")
                sweep += _fwd_block_rows_sweep(q, k, v, mask, o, lse)
            rows += here
            del out_t, qt, kt, vt
    return rows, sweep


class PlainAttention:
    """Stands in for ``MaskedAttention``: the plain PyTorch attention, which
    autograd differentiates (the CPU path)."""

    @staticmethod
    def apply(q, k, v, adj):
        from diffassemble_tpu_torch.ops.attention import _plain_masked_attention

        return _plain_masked_attention(q, k, v, adj, False)


def flagship_config():
    from diffassemble_tpu_torch.models import Diffusion2DConfig

    return Diffusion2DConfig(**json.loads(CONFIG.read_text()))


def seeded_puzzles(n: int, count: int, rotation: bool, rng, degree=None):
    """``count`` n×n puzzles of seeded random images, collated; with a
    ``degree`` the piece graph is that expander, else fully connected."""
    import numpy as np

    from diffassemble_tpu_torch.data import collate_puzzles, expander_mask, make_puzzle

    samples = []
    for _ in range(count):
        s = make_puzzle(rng.random((n * 32, n * 32, 3)).astype(np.float32), n, n, 32, rotation=rotation, rng=rng)
        if degree is not None:
            s["adj"] = expander_mask(n * n, degree, rng)
        samples.append(s)
    return collate_puzzles(samples, n * n)


def serving() -> tuple[dict[str, int], dict[str, dict[str, int]], list[float]]:
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch.cli.serve import PuzzleSolver
    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.ops import attention

    cfg = flagship_config()
    rng = np.random.default_rng(0)

    # one denoiser call: kernel attention against plain attention, bf16 and f32
    batch = seeded_puzzles(30, 1, cfg.rotation, rng).to("cuda")
    for dtype_name, rel_tol in (("float32", 1e-4), ("bfloat16", 5e-2)):
        model = Diffusion2D(dataclasses.replace(cfg, compute_dtype=dtype_name), device="cuda", seed=0)
        with torch.no_grad():
            feats = model.visual_features(batch.patches)
            x_t = torch.randn(batch.x0.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                              device="cuda")
            t = torch.full(x_t.shape[:2], 290, dtype=torch.int32, device="cuda")
            out_k = model.denoise(x_t, t, feats, batch.adj, batch.node_mask)
            with mock.patch.object(attention, "MaskedAttention", PlainAttention):
                out_p = model.denoise(x_t, t, feats, batch.adj, batch.node_mask)
        err = (out_k - out_p).abs().max().item()
        scale = out_p.abs().max().item()
        phase(f"denoiser {dtype_name}: kernel vs plain attention max|d|={err:.3e} "
              f"(max|out|={scale:.3e}, tol {rel_tol:g} of it)")
        if not (torch.isfinite(out_k).all() and err <= rel_tol * scale):
            raise AssertionError(f"denoiser with the kernel disagrees with plain attention ({dtype_name})")
        del model

    # a small puzzle end to end: the card (kernel) against the CPU (plain), f32
    small_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    small = seeded_puzzles(6, 1, cfg.rotation, rng)
    final_cpu = Diffusion2D(small_cfg, device="cpu", seed=0).sample(small.to("cpu")).final
    final_gpu = Diffusion2D(small_cfg, device="cuda", seed=0).sample(small.to("cuda")).final.cpu()
    err = (final_gpu - final_cpu).abs().max().item()
    phase(f"6x6 sample f32, card vs CPU: max|d|={err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("the card's sample disagrees with the CPU's")

    # the main path: serving requests
    solver = PuzzleSolver(cfg, seed=0, device="cuda", puzzle_size=30)
    images = [np.random.default_rng(100 + i).random((960, 960, 3)).astype(np.float32)
              for i in range(REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    per_request = cfg.n_layers * (cfg.steps // cfg.inference_ratio)
    reset_counts()
    for img in images:
        start, before, before_routes = time.perf_counter(), read_counts(), read_routes()
        out = solver.predict_array(img)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        launched = {k: v - before[k] for k, v in read_counts().items()}
        fwd_routes = routes_since(before_routes)["masked_attention_fwd"]
        phase(f"request: {seconds[-1]:.3f} s, kernel launches {launched}, forward by route {fwd_routes}, "
              f"output {out.shape}")
        if launched != {"masked_attention_fwd": per_request, "masked_attention_bwd_dq": 0,
                        "masked_attention_bwd_dkv": 0}:
            raise AssertionError(f"expected {per_request} forward launches and no backward launch per request")
        if fwd_routes != {"tensor_cores": per_request, "cuda_cores": 0}:
            raise AssertionError(f"expected all {per_request} forward launches on the tensor cores, got {fwd_routes}")
        if out.shape != (960, 960, 3) or not np.isfinite(out).all():
            raise AssertionError("bad output image")
    counts, routes = read_counts(), read_routes()
    phase(f"served {REQUESTS} requests: launches {counts}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    final = solver.model.sample(batch, torch.Generator(device="cuda").manual_seed(2)).final
    metrics = solver.model.metrics_from_final(final, batch)
    if not all(torch.isfinite(m.float()).all() for m in metrics.values()):
        raise AssertionError("non-finite metrics")
    phase(f"metrics_from_final (random weights): piece_acc {metrics['piece_acc'].tolist()}")
    return counts, routes, seconds


def gradient_parity() -> None:
    """A full-width f32 step's gradients with the kernels against the same
    step with plain attention, on two 30×30 puzzles with the flagship's 10%
    expander. Tolerance: 1e-3 of each parameter's largest gradient entry plus
    1e-6 of the model's (sums in another order through four layers and the
    encoder; gradients that are 0 in exact arithmetic are rounding noise)."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.ops import attention

    cfg = dataclasses.replace(flagship_config(), compute_dtype="float32", encoder_init="")
    batch = seeded_puzzles(30, 2, cfg.rotation, np.random.default_rng(3), degree="10%").to("cuda")
    model = Diffusion2D(cfg, device="cuda", seed=0)
    grads = []
    for swap in (False, True):
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(4)
        ctx = mock.patch.object(attention, "MaskedAttention", PlainAttention) if swap else contextlib.nullcontext()
        with ctx:
            before = read_counts()
            loss, _ = model.loss(batch, gen)
            loss.backward()
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in read_counts().items()}
        if launched != dict.fromkeys(KERNEL_SOURCES, 0 if swap else cfg.n_layers):
            raise AssertionError(f"unexpected launches {launched} (plain attention: {swap})")
        grads.append({k: p.grad.detach().clone() for k, p in model.named_parameters()})
    kern, plain = grads
    gmax = max(float(g.abs().max()) for g in plain.values())
    worst = 0.0
    for name, g in plain.items():
        err = float((kern[name] - g).abs().max())
        tol = 1e-3 * float(g.abs().max()) + 1e-6 * gmax
        worst = max(worst, err / tol)
        if not (torch.isfinite(kern[name]).all() and err <= tol):
            raise AssertionError(f"{name}: kernel gradient differs from plain by {err:.3e} (tol {tol:.3e})")
    qkv = [f"denoiser.gnn.transformer.layers.{i}.{p}.weight" for i in range(cfg.n_layers)
           for p in ("query", "key", "value")]
    smallest = min(float(kern[n].abs().max()) for n in qkv)
    if not smallest > 0:
        raise AssertionError("a query/key/value weight got no gradient through the kernels")
    phase(f"gradient parity f32, B=2 30x30: kernels vs plain attention, worst err/tol {worst:.3f} over "
          f"{len(plain)} parameters; all {len(qkv)} query/key/value weights finite, smallest max|g| {smallest:.3e}")


def card_vs_cpu_training() -> None:
    """Two f32 train steps on 6×6 puzzles on the card and on the CPU, with
    the same draws (made on the CPU): the loss within 1e-4 relative, and the
    parameters after two steps within 1e-3 of each parameter's largest step
    (gradients agree to ~1e-5 through another order of sums; Adafactor
    normalises them). Where an unfactored parameter's gradient is within
    rounding noise of 0, the direction of its step is set by that noise in
    either run: there the step is only held to Adafactor's clip, an RMS of at
    most lr·max(RMS(param), 1e-3)."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.train.adafactor import hf_relative_schedule
    from diffassemble_tpu_torch.train.train_state import create_train_state, make_train_step

    cfg = dataclasses.replace(flagship_config(), compute_dtype="float32", encoder_init="")
    host = seeded_puzzles(6, 2, cfg.rotation, np.random.default_rng(5), degree="10%")
    draw_gen = torch.Generator().manual_seed(6)
    draws = [dict(t_graph=torch.randint(0, cfg.steps, (2,), generator=draw_gen),
                  noise=torch.randn(host.x0.shape, generator=draw_gen)) for _ in range(2)]
    runs = {}
    for device in ("cpu", "cuda"):
        model = Diffusion2D(cfg, device=device, seed=0)
        opt = model.make_optimizer()
        state = create_train_state(model, opt, torch.Generator(device=device).manual_seed(0))
        it = iter(draws)
        step = make_train_step(lambda b, g: model.loss(b, g, **{k: v.to(device) for k, v in next(it).items()}), opt)
        batch = host.to(device)
        before = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
        losses = []
        for _ in range(2):
            state, aux = step(state, batch)
            losses.append(float(aux["total_loss"]))
        runs[device] = (losses, before, {k: p.detach().cpu() for k, p in model.named_parameters()},
                        {k: p.grad.detach().cpu() for k, p in model.named_parameters()}, set(state.opt_state["v"]))
    (l_cpu, before, p_cpu, g_cpu, unfactored), (l_gpu, _, p_gpu, _, _) = runs["cpu"], runs["cuda"]
    if not all(math.isfinite(x) and abs(x - y) <= 1e-4 * abs(y) for x, y in zip(l_gpu, l_cpu)):
        raise AssertionError(f"losses on the card {l_gpu} differ from the CPU's {l_cpu}")
    lr = hf_relative_schedule(cfg.warmup_steps)(1)  # the second update's (the first is 0 in warmup)
    gmax = max(float(g.abs().max()) for g in g_cpu.values())
    worst, undetermined = 0.0, 0
    for name, want in p_cpu.items():
        d_want, d_got = want - before[name], p_gpu[name] - before[name]
        tol = 1e-3 * float(d_want.abs().max()) + 1e-6 * want.abs()
        g = g_cpu[name]
        sure = torch.ones_like(g, dtype=torch.bool)
        if name in unfactored:
            sure = g.abs() > 1e-3 * float(g.abs().max()) + 1e-6 * gmax
        undetermined += int((~sure).sum())
        err = (d_got - d_want).abs()
        # plus 1e-6 of the parameter: the rounding of p + step in float32
        clip = lr * max(float(before[name].square().mean().sqrt()), 1e-3) * (1 + 1e-3) + 1e-6 * float(want.abs().max())
        if not (bool(torch.isfinite(d_got).all()) and bool((err <= tol)[sure].all())
                and float(d_got.square().mean().sqrt()) <= clip):
            raise AssertionError(f"{name}: the card's step differs from the CPU's")
        worst = max(worst, float((err / tol)[sure].max()) if sure.any() else 0.0)
    phase(f"6x6 train steps f32, card vs CPU: losses {l_gpu} vs {l_cpu}; parameters after 2 steps: "
          f"worst err/tol {worst:.3f}, {undetermined} entries with a gradient at rounding noise")


def drive_trainer(argvs: list[list[str]], label: str) -> tuple[list[dict], list[int]]:
    """Run the rotation CLI's ``main`` (``run_2d``, the ``Trainer``) once per
    argv; each train step is timed (host clock to a synchronize, and CUDA
    events) and its launches counted. Returns (steps, the number of steps of
    each run)."""
    import torch

    from diffassemble_tpu_torch.cli import train_2d_rot
    from diffassemble_tpu_torch.train import trainer as trainer_mod

    steps = []
    make_step = trainer_mod.make_train_step

    def counted_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def counted(state, batch):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            start, before, before_routes = time.perf_counter(), read_counts(), read_routes()
            ev[0].record()
            new, aux = step(state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in read_counts().items()}
            rec = {"step": new.step, "seconds": time.perf_counter() - start, "ms": ev[0].elapsed_time(ev[1]),
                   "launches": launched, "routes": routes_since(before_routes),
                   **{k: float(aux[k]) for k in ("grad_norm", "grad_norm/encoder", "grad_norm/denoiser",
                                                 "grad_nonfinite")},
                   "total_loss": float(aux.get("total_loss", aux["loss"]))}
            steps.append(rec)
            phase(f"{label} step {rec['step']}: {rec['seconds']:.3f} s, launches {launched}, "
                  f"loss {rec['total_loss']:.4f}, grad_norm {rec['grad_norm']:.4f} "
                  f"(encoder {rec['grad_norm/encoder']:.4f}, denoiser {rec['grad_norm/denoiser']:.4f})")
            return new, aux

        return counted

    runs = []
    with mock.patch.object(trainer_mod, "make_train_step", counted_make_train_step):
        for argv in argvs:
            before = len(steps)
            with mock.patch.object(sys, "argv", ["train_2d_rot", *argv]):
                train_2d_rot.main()
            runs.append(len(steps) - before)
    return steps, runs


def training(run_dir: Path) -> tuple[dict[str, int], dict[str, dict[str, int]], list[float]]:
    """The second main path: ``run_2d`` of the rotation CLI at full width,
    batch 8, 30×30; then a resume from its checkpoint. Each train step is
    timed (host clock to a synchronize) and its launches counted."""
    import torch

    argv = [*TRAIN_FLAGS, "--run_dir", str(run_dir)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps, runs = drive_trainer([argv + ["-max_steps", str(TRAIN_STEPS)],
                                 argv + ["-max_steps", str(TRAIN_STEPS + RESUME_STEPS)]], "train")
    first_run = runs[0]
    counts, routes = read_counts(), read_routes()
    peak = torch.cuda.max_memory_allocated()
    ckpts = sorted(int(p.name) for p in (run_dir / "checkpoints").iterdir() if p.name.isdigit())
    if first_run != TRAIN_STEPS or [s["step"] for s in steps] != list(range(1, TRAIN_STEPS + RESUME_STEPS + 1)):
        raise AssertionError(f"expected steps 1..{TRAIN_STEPS} then a resume to {TRAIN_STEPS + RESUME_STEPS}, "
                             f"got {[s['step'] for s in steps]}")
    _check_trainer_steps(steps, "train")
    if ckpts != [TRAIN_STEPS + RESUME_STEPS]:  # the latest (no eval metrics to rank by)
        raise AssertionError(f"checkpoints {ckpts}")
    metrics = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    sanity = [m for m in metrics if "sanity/overall__piece_acc" in m]
    if len(sanity) != 2:
        raise AssertionError("expected a sanity eval in each run")
    # steady steps: every step after the first of each run (the first pays warm-up)
    steady = [s["seconds"] for i, s in enumerate(steps) if i not in (0, first_run)]
    phase(f"training: {len(steps)} steps (resumed at step {TRAIN_STEPS}), launches {counts}, by route {routes}, "
          f"steady s/step {sum(steady) / len(steady):.3f} ({', '.join(f'{x:.3f}' for x in steady)}), "
          f"max_memory_allocated {peak / 2**30:.2f} GiB, checkpoints {ckpts}, "
          f"sanity piece_acc {[m['sanity/overall__piece_acc'] for m in sanity]}")
    return counts, routes, steady


def heldout_setup(n_puzzles: int):
    """The trained flagship on the card, bf16 as configured, and the first
    ``n_puzzles`` of its held-out corpus over the committed expander: (config,
    data recipe, model, corpus, rotation draw, whether this card's own
    ``build_device_data`` kept the committed expander, the asset's extras)."""
    import numpy as np
    import torch

    from diffassemble_tpu_torch import convert
    from diffassemble_tpu_torch.data.datasets import SyntheticImages
    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.train.device_data import build_device_data

    cfg = flagship_config()
    recipe = json.loads(DATA.read_text())
    state, extras = convert.load_jax_npz(ASSET)
    model = Diffusion2D(cfg, device="cuda")
    model.load_state_dict(state, strict=True)
    hw = (recipe["hw"][0], recipe["hw"][0])
    images = SyntheticImages((hw[0] * 32, hw[1] * 32), n=n_puzzles, seed=recipe["seed"] + 1000, cache=False,
                             canonical=recipe["canonical"], hf_detail=recipe["hf_detail"], style=recipe["style"])
    data = build_device_data(images, hw, n_puzzles, degree=recipe["degree"], seed=recipe["seed"], device="cuda")
    committed = torch.as_tensor(committed_adj(), device="cuda")
    own_graph = torch.equal(data.adj, committed)
    rot_k = torch.as_tensor(extras["heldout_rot_k"][:n_puzzles].astype(np.int64), device="cuda")
    return cfg, recipe, model, data._replace(adj=committed), rot_k, own_graph, extras


def accuracy() -> tuple[dict[str, int], dict[str, dict[str, int]], dict]:
    """The third main path: the trained flagship checkpoint (its EMA at step
    32000, converted and committed) under bench.py's held-out protocol, bf16
    as configured: 64 ``SyntheticImages`` of 960x960 with the recipe's knobs
    (``data.json``, seed + 1000), one expander shared by all, the committed
    rotation draw, ``heldout_eval`` in calls of 32 puzzles.

    The recipe's seed does not fix the expander: ``expander_mask`` draws five
    candidates, circulant graphs under five permutations whose Fiedler values
    are equal, and keeps the one that ARPACK's rounding ranks first, so the
    TPU's figure was measured over one of the five, which one unknown. The
    counted run is over the committed candidate; then each other candidate
    runs. The phase fails unless every forward launch of the counted run took
    the tensor cores and the TPU's piece_acc lies within PIECE_ACC_TOL of the
    card's over at least one candidate. Then, ungated, the same puzzles over a
    fully connected graph (as ``cli/serve.py`` serves) and in calls of 8."""
    import numpy as np
    import torch

    from diffassemble_tpu_torch.data import expander_mask
    from diffassemble_tpu_torch.train.heldout import heldout_eval

    start = time.perf_counter()
    cfg, recipe, model, data, rot_k, own_graph, extras = heldout_setup(EVAL_TOTAL)
    committed = data.adj
    rng = np.random.default_rng(recipe["seed"])
    candidates = [torch.as_tensor(expander_mask(data.n_nodes, recipe["degree"], rng, max_num_iters=1), device="cuda")
                  for _ in range(EXPANDER_TRIES)]
    chosen = [i for i, c in enumerate(candidates) if torch.equal(c, committed)]
    phase(f"held-out corpus: {EVAL_TOTAL} images made and patchified, model loaded in "
          f"{time.perf_counter() - start:.2f} s, patches {tuple(data.patches.shape)}; rotation draw of JAX "
          f"{extras['jax_version']} (threefry partitionable {bool(extras['jax_threefry_partitionable'])}); the "
          f"committed expander is candidate {chosen} of {EXPANDER_TRIES}; the one this card's build_device_data "
          f"kept equals it: {own_graph}")
    if len(chosen) != 1:
        raise AssertionError("the committed expander is not one of the recipe's candidates")

    calls = []
    sample = model.sample

    def timed_sample(*args, **kwargs):
        """``model.sample`` timed by CUDA events and the host clock."""
        host = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = sample(*args, **kwargs)
        ev[1].record()
        torch.cuda.synchronize()
        calls.append({"puzzles": args[0].patches.shape[0], "ms": ev[0].elapsed_time(ev[1]),
                      "host_s": time.perf_counter() - host})
        return out

    model.sample = timed_sample
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics = heldout_eval(model, data, rot_k, eval_n=EVAL_N)
    counts, routes = read_counts(), read_routes()
    peak = torch.cuda.max_memory_allocated()
    model.sample = sample
    per_call = cfg.n_layers * (cfg.steps // cfg.inference_ratio)
    n_calls = -(-EVAL_TOTAL // EVAL_N)
    for c in calls:
        phase(f"held-out call of {c['puzzles']} puzzles: {c['ms']:.2f} ms (CUDA events), {c['host_s']:.3f} s host")
    phase(f"held-out eval: launches {counts}, forward by route {routes['masked_attention_fwd']}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if counts != {"masked_attention_fwd": n_calls * per_call, "masked_attention_bwd_dq": 0,
                  "masked_attention_bwd_dkv": 0}:
        raise AssertionError(f"expected {n_calls * per_call} forward launches and no backward launch")
    if routes["masked_attention_fwd"] != {"tensor_cores": n_calls * per_call, "cuda_cores": 0}:
        raise AssertionError(f"expected every forward launch on the tensor cores, got {routes}")

    by_graph = {}
    for i, cand in enumerate(candidates):
        m = metrics if i == chosen[0] else heldout_eval(model, data._replace(adj=cand), rot_k, eval_n=EVAL_N)
        by_graph[f"candidate {i}"] = {"piece_acc": m["overall__piece_acc"], "puzzle_acc": m["overall_acc"],
                                      "puzzles": m["overall_nImages"], "committed": i == chosen[0]}
        phase(f"held-out accuracy, bf16, expander candidate {i}{' (committed)' if i == chosen[0] else ''}: "
              f"piece_acc {m['overall__piece_acc']!r}, puzzle_acc {m['overall_acc']!r} over "
              f"{m['overall_nImages']:g} puzzles")
    nearest = min(by_graph, key=lambda g: abs(by_graph[g]["piece_acc"] - TPU_PIECE_ACC))
    gap = abs(by_graph[nearest]["piece_acc"] - TPU_PIECE_ACC)
    phase(f"held-out accuracy gate: the TPU's piece_acc {TPU_PIECE_ACC} is {gap:.4f} from the card's over "
          f"{nearest} (tolerance {PIECE_ACC_TOL})")
    if any(g["puzzles"] != EVAL_TOTAL for g in by_graph.values()) or not gap <= PIECE_ACC_TOL:
        raise AssertionError(f"no expander candidate gives a piece_acc within {PIECE_ACC_TOL} of the TPU's "
                             f"{TPU_PIECE_ACC}: {by_graph}")
    result = {"piece_acc": metrics["overall__piece_acc"], "puzzle_acc": metrics["overall_acc"], "calls": calls,
              "max_memory_allocated": peak, "by_expander": by_graph, "nearest_to_tpu": nearest,
              "own_expander_equals_committed": own_graph, "ungated": {}}

    for label, variant, eval_n in (("fully connected", data._replace(adj=torch.ones_like(committed)), EVAL_N),
                                   ("committed expander, calls of 8", data, 8)):
        m = heldout_eval(model, variant, rot_k, eval_n=eval_n)
        result["ungated"][label] = {"piece_acc": m["overall__piece_acc"], "puzzle_acc": m["overall_acc"]}
        phase(f"held-out accuracy (ungated), {label}: piece_acc {m['overall__piece_acc']!r}, "
              f"puzzle_acc {m['overall_acc']!r}")
    return counts, routes, result


def recipe_argv(run_dir: str, data_recipe: dict, max_steps: int, train_n: int, eval_n: int, eval_every: int,
                backbone: str | None = None, encoder_init: bool = True, config: Path = CONFIG,
                batch: int = TRAIN_BATCH, ema_decay: float = EMA_DECAY) -> list[str]:
    """``cli/train_device.py``'s flags for a run's config.json (default the
    flagship's: widths, sampler, backbone and, with ``encoder_init``, its
    pretrained encoder) and a data recipe (``data.json``: sizes, graph, image
    knobs, seed), at ``batch`` with ``ema_decay``, cut to the given corpora
    and steps; no reconstruction images (the card machine has no PIL)."""
    cfg = json.loads(config.read_text())
    encoder_init = str(ROOT / cfg["encoder_init"]) if encoder_init and cfg["encoder_init"] else ""
    return [
        "--run_dir", run_dir, "--hw", *map(str, data_recipe["hw"]), "--rotation", str(int(cfg["rotation"])),
        "--backbone", backbone or cfg["backbone"], "--architecture", cfg["architecture"],
        "--degree", str(data_recipe["degree"]), "--virt_nodes", str(cfg["virt_nodes"]),
        "--n_layers", str(cfg["n_layers"]), "--steps", str(cfg["steps"]),
        "--inference_ratio", str(cfg["inference_ratio"]), "--batch_size", str(batch),
        "--train_n", str(train_n), "--eval_n", str(eval_n), "--max_steps", str(max_steps),
        "--eval_every", str(eval_every), "--log_every", "1", "--compute_dtype", cfg["compute_dtype"],
        "--warmup_steps", str(cfg["warmup_steps"]), "--aux_loss_weight", str(cfg["aux_loss_weight"]),
        "--encoder_init", encoder_init, "--hf_detail", str(data_recipe["hf_detail"]),
        "--canonical", str(data_recipe["canonical"]), "--style", data_recipe["style"],
        "--seed", str(data_recipe["seed"]), "--ema_decay", str(ema_decay), "--viz_every_eval", "0",
        "--device", "cuda",
    ]


def drive_recipe(workdir: Path, argvs: list[list[str]], label: str) -> tuple[list[dict], list[dict]]:
    """Run ``cli/train_device.py``'s ``main`` once per argv, in ``workdir``
    (its corpus cache lands there), past the round-deadline guard's cutoff
    (the repository's PROGRESS.jsonl is from another time). Each train step is
    timed (host clock synchronize to synchronize, and CUDA events) and its
    launches counted, as is each held-out evaluation. Returns (steps, evals)."""
    import os

    import torch

    from diffassemble_tpu_torch.cli import train_device

    steps, evals = [], []
    make_step, heldout = train_device.make_device_train_step, train_device.heldout_eval

    def counted_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def counted(state, data, batch_size, draws=None):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            start, before, before_routes = time.perf_counter(), read_counts(), read_routes()
            ev[0].record()
            new, aux = step(state, data, batch_size, draws)
            ev[1].record()
            torch.cuda.synchronize()
            rec = {"step": new.step, "seconds": time.perf_counter() - start, "ms": ev[0].elapsed_time(ev[1]),
                   "launches": {k: v - before[k] for k, v in read_counts().items()},
                   "routes": routes_since(before_routes),
                   **{k: float(aux[k]) for k in ("total_loss", "grad_norm", "grad_norm/encoder",
                                                 "grad_norm/denoiser")}}
            steps.append(rec)
            phase(f"{label} step {rec['step']}: {rec['seconds']:.3f} s host, {rec['ms']:.2f} ms CUDA events, "
                  f"launches {rec['launches']}, loss {rec['total_loss']:.4f}, grad_norm {rec['grad_norm']:.4f}")
            return new, aux

        return counted

    def counted_heldout(model, data, rot_k, eval_n=32, on_slice=None):
        torch.cuda.synchronize()
        start, before, before_routes = time.perf_counter(), read_counts(), read_routes()
        metrics = heldout(model, data, rot_k, eval_n=eval_n, on_slice=on_slice)
        torch.cuda.synchronize()
        rec = {"calls": -(-data.n_samples // eval_n), "puzzles": data.n_samples, "n_nodes": data.n_nodes,
               "seconds": time.perf_counter() - start,
               "launches": {k: v - before[k] for k, v in read_counts().items()},
               "routes": routes_since(before_routes), "piece_acc": metrics["overall__piece_acc"],
               "metrics": metrics}
        evals.append(rec)
        phase(f"{label} evaluation: {rec['puzzles']} puzzles in {rec['calls']} call(s), {rec['seconds']:.3f} s, "
              f"launches {rec['launches']}, piece_acc {rec['piece_acc']!r}")
        return metrics

    env = {"DIFFASSEMBLE_DEADLINE_EPOCH": str(time.time() + 86400.0)}
    with mock.patch.object(train_device, "make_device_train_step", counted_make_step), \
            mock.patch.object(train_device, "heldout_eval", counted_heldout), \
            mock.patch.dict(os.environ, env), contextlib.chdir(workdir):
        for argv in argvs:
            train_device.main(argv)
    return steps, evals


def _check_recipe_launches(steps: list[dict], evals: list[dict], per_call: int, label: str) -> None:
    """Every step 4 + 4 + 4 launches, every evaluation ``per_call`` forward
    launches a call and no backward, all on the tensor cores; finite losses."""
    step_want = dict.fromkeys(KERNEL_SOURCES, 4)
    step_routes = dict.fromkeys(KERNEL_SOURCES, {"tensor_cores": 4, "cuda_cores": 0})
    for s in steps:
        if s["launches"] != step_want or s["routes"] != step_routes:
            raise AssertionError(f"{label} step {s['step']}: launches {s['launches']} by route {s['routes']}, "
                                 f"expected {step_want}, all on the tensor cores")
        if not (math.isfinite(s["total_loss"]) and math.isfinite(s["grad_norm"]) and s["grad_norm/encoder"] > 0
                and s["grad_norm/denoiser"] > 0):
            raise AssertionError(f"{label} step {s['step']}: bad loss or gradient norms {s}")
    for e in evals:
        n = per_call * e["calls"]
        if (e["launches"] != {"masked_attention_fwd": n, "masked_attention_bwd_dq": 0, "masked_attention_bwd_dkv": 0}
                or e["routes"]["masked_attention_fwd"] != {"tensor_cores": n, "cuda_cores": 0}):
            raise AssertionError(f"{label} evaluation: launches {e['launches']} by route {e['routes']}, expected "
                                 f"{n} forward launches on the tensor cores")


def _spread(xs: list[float]) -> str:
    xs = sorted(xs)
    return f"median {xs[len(xs) // 2]:.4f} (min {xs[0]:.4f}, max {xs[-1]:.4f}, n {len(xs)})"


def recipe(workdir: Path) -> tuple[dict[str, int], dict[str, dict[str, int]], dict]:
    """The fourth main path: the flagship's device-resident recipe through
    ``cli/train_device.py`` (config.json and data.json: 30×30, 10% expander,
    canonical 0.8, hf_detail 0.25, the encoder_init, batch 8, EMA), cut to
    corpora of 16 and 8 puzzles and 6 steps with an evaluation every 3, then a
    resume to step 8. Gates: 4 + 4 + 4 tensor-core launches a step, 120 a
    held-out call, finite losses, checkpoints at 3 and 6 then 8, data.json
    equal to the arguments."""
    import numpy as np
    import torch

    data_recipe = json.loads(DATA.read_text())
    run_dir = workdir / "recipe"
    argvs = [recipe_argv(str(run_dir), data_recipe, steps, RECIPE_TRAIN_N, RECIPE_EVAL_N, RECIPE_EVAL_EVERY)
             for steps in (RECIPE_STEPS, RECIPE_RESUME_TO)]
    if not ENCODER_INIT.is_file():
        raise FileNotFoundError(f"the flagship's encoder_init {ENCODER_INIT} is not in this checkout")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    steps, evals = drive_recipe(workdir, argvs[:1], "recipe")
    ckpt_dir = run_dir / "checkpoints"
    first = sorted(int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit())
    more_steps, more_evals = drive_recipe(workdir, argvs[1:], "recipe (resumed)")
    seconds = time.perf_counter() - start
    counts, routes = read_counts(), read_routes()
    peak = torch.cuda.max_memory_allocated()
    after = sorted(int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit())
    cfg = flagship_config()
    per_call = cfg.n_layers * (cfg.steps // cfg.inference_ratio)
    _check_recipe_launches(steps + more_steps, evals + more_evals, per_call, "recipe")
    if [s["step"] for s in steps + more_steps] != list(range(1, RECIPE_RESUME_TO + 1)):
        raise AssertionError(f"recipe steps {[s['step'] for s in steps + more_steps]}")
    # evaluations at steps 3 and 6 and a final one, then at 8 and a final one
    if len(evals) != 3 or len(more_evals) != 2:
        raise AssertionError(f"recipe evaluations: {len(evals)} then {len(more_evals)}")
    if first != [RECIPE_EVAL_EVERY, RECIPE_STEPS] or RECIPE_RESUME_TO not in after:
        raise AssertionError(f"recipe checkpoints {first}, then {after}")
    written = json.loads((ckpt_dir / "data.json").read_text())
    want = {**{k: data_recipe[k] for k in ("dataset", "hw", "degree", "canonical", "hf_detail", "style", "seed")},
            "train_n": RECIPE_TRAIN_N}
    if written != want:
        raise AssertionError(f"data.json {written} differs from the arguments {want}")
    hwtag = "x".join(map(str, data_recipe["hw"]))
    corpus = 0
    for f in (workdir / "runs" / "_corpus").glob(f"*-hw{hwtag}-*.npz"):
        with np.load(f) as z:
            corpus += sum(int(z[k].nbytes) for k in z.files)
    steady = [s for i, s in enumerate(steps + more_steps) if i not in (0, len(steps))]
    result = {"seconds": seconds, "steady_host_s": [s["seconds"] for s in steady],
              "steady_cuda_ms": [s["ms"] for s in steady], "first_step_s": [steps[0]["seconds"],
                                                                            more_steps[0]["seconds"]],
              "max_memory_allocated": peak, "corpus_bytes_on_device": corpus, "checkpoints": after,
              "eval_seconds": [e["seconds"] for e in evals + more_evals],
              "piece_acc": [e["piece_acc"] for e in evals + more_evals]}
    phase(f"recipe: {len(steady) + 2} steps in two runs, {seconds:.1f} s with corpora, evaluations and "
          f"checkpoints; steady s/step by host clock {_spread(result['steady_host_s'])}, by CUDA events (ms) "
          f"{_spread(result['steady_cuda_ms'])}; max_memory_allocated {peak / 2**30:.2f} GiB; both corpora "
          f"{corpus} bytes on the device; checkpoints {first} then {after}; launches {counts}")
    return counts, routes, result


def recipe_corpus():
    """A device-resident corpus of 8 puzzles of the flagship's recipe
    (data.json: its size, expander, seed and image knobs) on the card."""
    from diffassemble_tpu_torch.data.datasets import SyntheticImages
    from diffassemble_tpu_torch.train.device_data import build_device_data

    recipe_ = json.loads(DATA.read_text())
    hw = (recipe_["hw"][0],) * 2
    images = SyntheticImages((hw[0] * 32, hw[1] * 32), n=TRAIN_BATCH, seed=recipe_["seed"], cache=False,
                             canonical=recipe_["canonical"], hf_detail=recipe_["hf_detail"], style=recipe_["style"])
    return build_device_data(images, hw, TRAIN_BATCH, degree=recipe_["degree"], seed=recipe_["seed"], device="cuda")


def device_step_vs_train_state_step() -> None:
    """On the card, one ``make_device_train_step`` step against one
    ``train_state.make_train_step`` step: the flagship at full width in bf16
    from its encoder_init, the same batch of 8 30×30 puzzles (the recipe's
    images and expander) and the same draws. Both gradients are finite, so
    the train-state step's non-finite zeroing does nothing; the steps differ
    only in how the clip computes the norm. Tolerance as the CPU test holds
    the device step: the loss and gradient norms within 2e-4 relative, the
    parameters and EMA within 5e-4 of each parameter's largest update plus
    1e-6 relative, except where an unfactored parameter's gradient is within
    2e-4 of its largest entry plus 1e-6 of the model's of 0 (there the
    first Adafactor step is the sign of the gradient), where the step is only
    held to the largest."""
    import dataclasses

    import torch

    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.train.device_data import gather_batch, make_device_train_step
    from diffassemble_tpu_torch.train.train_state import create_train_state, make_train_step

    cfg = dataclasses.replace(flagship_config(), encoder_init=str(ENCODER_INIT))
    data = recipe_corpus()
    gen = torch.Generator(device="cuda").manual_seed(5)
    runs = []
    for kind in ("device", "train_state"):
        model = Diffusion2D(cfg, device="cuda", seed=0)
        model.init(0)
        gen.manual_seed(5)
        idx = torch.randint(0, data.n_samples, (TRAIN_BATCH,), generator=gen, device="cuda")
        rot_k = torch.randint(0, 4, (TRAIN_BATCH, data.n_nodes), generator=gen, device="cuda")
        draws = model.loss_draws(TRAIN_BATCH, (TRAIN_BATCH, data.n_nodes, 4), gen, torch.device("cuda"))
        opt = model.make_optimizer()
        state = create_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0), ema=True)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        if kind == "device":
            step = make_device_train_step(model.loss, opt, rotation=True, ema_decay=EMA_DECAY)
            state, aux = step(state, data, TRAIN_BATCH, {"idx": idx, "rot_k": rot_k, **draws})
        else:
            step = make_train_step(lambda b, g: model.loss(b, g, **draws), opt, ema_decay=EMA_DECAY)
            state, aux = step(state, gather_batch(data, idx, rot_k))
        torch.cuda.synchronize()
        runs.append((aux, before, {k: p.detach().clone() for k, p in model.named_parameters()},
                     {k: p.grad.detach().clone() for k, p in model.named_parameters()},
                     {k: e.clone() for k, e in state.ema_params.items()}, set(state.opt_state["v"])))
        del model, state, opt
    (aux_d, before, p_d, _, ema_d, _), (aux_t, _, p_t, g_t, ema_t, unfactored) = runs
    if float(aux_t["grad_nonfinite"]) != 0.0:
        raise AssertionError("the train-state step saw non-finite gradients")
    for key in ("loss", "total_loss", "aux_loss", "grad_norm", "grad_norm/encoder", "grad_norm/denoiser"):
        a, b = float(aux_d[key]), float(aux_t[key])
        if not (math.isfinite(a) and abs(a - b) <= 2e-4 * abs(b)):
            raise AssertionError(f"{key}: device step {a} against train-state step {b}")
    gmax = max(float(g.abs().max()) for g in g_t.values())
    worst = 0.0
    for name, want in p_t.items():
        g = g_t[name]
        g_tol = 2e-4 * float(g.abs().max()) + 1e-6 * gmax
        sure = g.abs() > g_tol if name in unfactored else torch.ones_like(g, dtype=torch.bool)
        for got_all, want_all in ((p_d, p_t), (ema_d, ema_t)):
            d_got, d_want = got_all[name] - before[name], want_all[name] - before[name]
            largest = float(d_want.abs().max())
            tol = 5e-4 * largest + 1e-6 * want_all[name].abs()
            err = (d_got - d_want).abs()
            if not (bool(torch.isfinite(d_got).all()) and bool((err <= tol)[sure].all())
                    and bool((d_got.abs() <= largest + tol)[~sure].all())):
                raise AssertionError(f"{name}: the device step's update differs from the train-state step's")
            if sure.any():
                worst = max(worst, float((err / tol)[sure].max()))
    phase(f"device step vs train-state step, {cfg.compute_dtype} B={TRAIN_BATCH} {data.hw.tolist()}: loss "
          f"{float(aux_d['total_loss']):.6f} vs "
          f"{float(aux_t['total_loss']):.6f}, grad_norm {float(aux_d['grad_norm']):.6f} vs "
          f"{float(aux_t['grad_norm']):.6f}; parameters and EMA worst err/tol {worst:.3f} over {len(p_t)}")


def mixed_masks(corpus_file: Path):
    """(label, mask (B, N+8, N+8) bool on the card) of the mixed corpus's
    first batch of ``MIXED_BATCH`` (its puzzles in order, sizes 6/8/10/12
    padded to 144 + 8 virtual nodes), as the denoiser builds it."""
    import numpy as np
    import torch

    from diffassemble_tpu_torch.ops.attention import extend_mask_with_virtual_nodes
    from diffassemble_tpu_torch.train.device_data import DeviceMixedPuzzleData, gather_batch_mixed

    with np.load(corpus_file) as z:
        data = DeviceMixedPuzzleData(*(torch.from_numpy(z[k]).cuda() for k in DeviceMixedPuzzleData._fields))
    batch = gather_batch_mixed(data, torch.arange(MIXED_BATCH, device="cuda"))
    mask, _ = extend_mask_with_virtual_nodes(batch.adj, batch.node_mask, 8)
    sizes = batch.patches_dim[:, 0].tolist()
    return f"mixed {'/'.join(map(str, sorted(set(sizes))))} padded", mask.contiguous()


def mixed(workdir: Path) -> tuple[dict[str, int], dict[str, dict[str, int]], dict]:
    """The fifth main path: the mixed-size recipe of ``weights/diffusion2d_rot_ms``
    (its config.json: resnet18equiv at the flagship's widths; its data.json:
    sizes 6/8/10/12 padded to 144 pieces, fully connected) through
    ``cli/train_device.py`` from seeded weights at its run's batch of 16
    without EMA: 3 steps with an evaluation, then a resume to step 4, each
    step through OrientationNorm's backward and the three kernels. Its
    seeded f32 loss on two puzzles of the corpus, card against CPU on the
    same draws, within ``TOL_LOSS_3D["float32"]``. Then the three kernels
    against their plain versions on the masks of its first batch (N = 152
    with 8 virtual nodes: rows of padding nodes attend to no key, their
    columns are attended by no query) and their times there."""
    data_recipe = json.loads(MIXED_DATA.read_text())
    run_dir = workdir / "mixed"
    argvs = [recipe_argv(str(run_dir), data_recipe, steps, RECIPE_TRAIN_N, RECIPE_EVAL_N, MIXED_STEPS,
                         config=MIXED_CONFIG, batch=MIXED_BATCH, ema_decay=0.0)
             for steps in (MIXED_STEPS, MIXED_RESUME_TO)]
    reset_counts()
    start = time.perf_counter()
    steps, evals = drive_recipe(workdir, argvs, "mixed")
    seconds = time.perf_counter() - start
    counts, routes = read_counts(), read_routes()
    cfg = mixed_config()
    _check_recipe_launches(steps, evals, cfg.n_layers * (cfg.steps // cfg.inference_ratio), "mixed")
    # an evaluation at step 3 and a final one, then at step 4 and a final one
    if [s["step"] for s in steps] != list(range(1, MIXED_RESUME_TO + 1)) or len(evals) != 4:
        raise AssertionError(f"mixed: steps {[s['step'] for s in steps]}, {len(evals)} evaluations")
    n_max = max(data_recipe["hw"]) ** 2
    if any(e["n_nodes"] != n_max for e in evals):
        raise AssertionError(f"mixed: the held-out corpus is not padded to {n_max} pieces: {evals}")
    saved = json.loads((run_dir / "checkpoints" / "config.json").read_text())
    if saved["backbone"] != "resnet18equiv":
        raise AssertionError(f"mixed: the run's config.json {saved}")
    phase(f"mixed ({cfg.backbone}, B={MIXED_BATCH}): {len(steps)} steps in two runs in {seconds:.1f} s, host s/step "
          f"{[round(s['seconds'], 4) for s in steps]}, CUDA events ms {[round(s['ms'], 2) for s in steps]}; "
          f"launches {counts}")
    corpus = next((workdir / "runs" / "_corpus").glob(f"train-hw{'x'.join(map(str, data_recipe['hw']))}-*.npz"))
    losses = mixed_loss_card_vs_cpu(corpus)
    return counts, routes, {"corpus": corpus, "run_dir": run_dir, "steps": steps, "evals": evals,
                            "seconds": seconds, "loss_f32_card": losses}


def mixed_config():
    from diffassemble_tpu_torch.models import Diffusion2DConfig

    return Diffusion2DConfig(**json.loads(MIXED_CONFIG.read_text()))


def card_vs_cpu_loss_2d(make_model, batch, draws: dict, label: str) -> dict[str, float]:
    """One f32 loss dict of ``make_model(device)`` (seeded weights) on
    ``batch`` with the numpy ``draws``, on the card and on the CPU: each term
    within 2e-3 relative and ``total_loss`` within 2e-4 (PR 11's f32 gate,
    ``TOL_LOSS_3D["float32"]``). Returns the card's."""
    import torch

    term, total = TOL_LOSS_3D["float32"]
    out = {}
    for device in ("cpu", "cuda"):
        model = make_model(device)
        with torch.no_grad():
            _, aux = model.loss(batch.to(device), **{k: torch.as_tensor(v).to(device) for k, v in draws.items()})
        out[device] = {k: float(v) for k, v in aux.items()}
        del model
    worst = 0.0
    for key, want in out["cpu"].items():
        got = out["cuda"][key]
        tol = (total if key == "total_loss" else term) * abs(want) + 1e-12
        worst = max(worst, abs(got - want) / tol)
        if not (math.isfinite(got) and abs(got - want) <= tol):
            raise AssertionError(f"{label}: f32 {key} on the card {got!r}, on the CPU {want!r}")
    phase(f"{label}: seeded f32 loss, card vs CPU on the same draws, worst err/tol {worst:.3f}: "
          f"{ {k: round(v, 6) for k, v in out['cuda'].items()} }")
    return out["cuda"]


def mixed_loss_card_vs_cpu(corpus: Path) -> dict[str, float]:
    """``card_vs_cpu_loss_2d`` of the mixed run's model on the first two
    puzzles of its corpus (sizes 6 and 8, padded to 144) with numpy draws of
    the rotations, t and the noise."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.train.device_data import DeviceMixedPuzzleData, gather_batch_mixed

    cfg = dataclasses.replace(mixed_config(), compute_dtype="float32")
    with np.load(corpus) as z:
        data = DeviceMixedPuzzleData(*(torch.from_numpy(z[k]) for k in DeviceMixedPuzzleData._fields))
    rng = np.random.default_rng(LOSS3D_SEED)
    batch = gather_batch_mixed(data, torch.arange(2), torch.as_tensor(rng.integers(0, 4, (2, data.n_nodes))))
    draws = {"t_graph": rng.integers(0, cfg.steps, 2),
             "noise": rng.standard_normal(tuple(batch.x0.shape)).astype(np.float32)}
    return card_vs_cpu_loss_2d(lambda device: Diffusion2D(cfg, device=device, seed=0), batch, draws, "mixed")


def mixed_kernels(corpus: Path, max_err: dict[str, float]) -> list[dict]:
    """The three kernels on the mixed corpus's masks: against their plain
    versions (bf16 on the tensor cores, f32 on the CUDA cores, at Dh 32 and
    144, the same tolerances and exact zeros as every other mask), then timed
    (``time_on_masks``)."""
    import torch

    label, mask = mixed_masks(corpus)
    b, n, _ = mask.shape
    pairs = int(mask.sum())
    phase(f"mixed masks: {label}, B={b} N={n}, {int((~mask.any(-1)).sum())} empty query rows, "
          f"{pairs} attended pairs ({pairs / mask.numel():.3f} of B·N²)")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dh in MAIN_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            _check_kernels(label, mask, dh, dtype, gen, max_err)
    return time_on_masks(mask, label, MAIN_HEAD_DIMS, gen)


def time_on_masks(mask, label: str, widths, gen) -> list[dict]:
    """The three kernels timed on ``mask`` at each head width in bf16, beside
    their plain versions, the bound over the mask's attended pairs and
    ``scaled_dot_product_attention`` with the same boolean mask (its forward,
    and one backward for dQ, dK and dV together). One row a kernel and
    width; the caller adds its launches (``attach_launches_2d``)."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    b, n, _ = mask.shape
    pairs = int(mask.sum())
    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dh in widths:
        q, k, v, dout = (torch.randn((b, n, HEADS, dh), generator=gen, device="cuda").to(torch.bfloat16)
                         for _ in range(4))
        o, lse = ca.masked_attention_fwd(q, k, v, mask)
        delta = ca.attention_delta(dout, o)
        args = (q, k, v, mask, dout, lse, delta)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        sdpa_mask = mask[:, None]
        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=sdpa_mask))
        out_t = sdpa(qt, kt, vt, attn_mask=sdpa_mask)
        dout_t = dout.transpose(1, 2).contiguous()
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(out_t, (qt, kt, vt), dout_t, retain_graph=True))
        here = []
        for kernel, fn, plain, library_ms in (
                ("masked_attention_fwd", lambda: ca.masked_attention_fwd(q, k, v, mask),
                 lambda: ca.masked_attention_fwd_plain(q, k, v, mask), lib_fwd),
                ("masked_attention_bwd_dq", lambda: ca.masked_attention_bwd_dq(*args),
                 lambda: ca.masked_attention_bwd_dq_plain(*args), lib_bwd),
                ("masked_attention_bwd_dkv", lambda: ca.masked_attention_bwd_dkv(*args),
                 lambda: ca.masked_attention_bwd_dkv_plain(*args), lib_bwd)):
            ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
            bound, bound_by = bound_ms(kernel, b, n, HEADS, dh, 2, pairs=pairs)
            route = ca.route(kernel, *args)
            here.append({"kernel": kernel, "b": b, "n": n, "dh": dh, "route": route, "main_path": True,
                         "mask": label, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": bound, "bound_by": bound_by})
            phase(f"timing {kernel:25s} B={b} N={n} H={HEADS} Dh={dh:3d} bf16 {route:12s} ({label}): kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
                  f"bound {bound:.6f} ms ({bound_by})")
        pair = here[1]["ms"] + here[2]["ms"]
        phase(f"timing backward pair          B={b} N={n} H={HEADS} Dh={dh:3d} bf16 {here[1]['route']:12s}: "
              f"dQ + dK/dV {pair:.4f} ms against one SDPA backward {lib_bwd:.4f} ms ({pair / lib_bwd:.2f}x), "
              f"{pair / (here[1]['bound_ms'] + here[2]['bound_ms']):.0f}x their bound")
        rows += here
        del out_t, qt, kt, vt
    return rows


def ddp_world_of_one() -> tuple[dict[str, int], dict[str, dict[str, int]]]:
    """One ``Trainer`` step at full width (bf16, the flagship's config and
    encoder_init, batch 8 of 30×30 puzzles over the 10% expander) without a
    process group, under DDP in a world of one over NCCL (this process,
    localhost), and without again: parameters and gradients bit-equal. cuDNN
    runs its deterministic algorithms here."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.parallel.dryrun import one_rank_ddp_matches

    cfg = dataclasses.replace(flagship_config(), encoder_init=str(ENCODER_INIT))
    rng = np.random.default_rng(8)
    batch = seeded_puzzles(30, TRAIN_BATCH, cfg.rotation, rng).to("cuda")
    adj = torch.as_tensor(seeded_puzzles(30, 1, cfg.rotation, rng, degree="10%").adj).cuda()
    batch = batch._replace(adj=batch.adj & adj)
    reset_counts()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        n = one_rank_ddp_matches(lambda: Diffusion2D(cfg, device="cuda", seed=0), batch, "nccl")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    counts, routes = read_counts(), read_routes()
    if counts != dict.fromkeys(KERNEL_SOURCES, 3 * 4):
        raise AssertionError(f"ddp: launches {counts}, expected 4 of each kernel in each of 3 steps")
    phase(f"ddp: a world of one over NCCL, one Trainer step bit-equal to the plain step ({n} parameters and "
          f"their gradients; a second plain step equal too); launches {counts}")
    return counts, routes


def first_batch_3d(protocol: dict):
    """The 3D protocol's first call on the card: its first 16 objects,
    collated as the protocol collates them."""
    import numpy as np

    from diffassemble_tpu_torch.data.breaking_bad import collate_fragments
    from diffassemble_tpu_torch.train.heldout3d import protocol_corpus

    p = protocol
    ds = protocol_corpus(p, test_n=p["batch"])
    nb = collate_fragments([ds[i] for i in range(len(ds))], p["max_num_part"], rng=np.random.default_rng(p["seed"]))
    return nb.to("cuda")


def kernels_3d(protocol: dict, heads: int, widths: tuple[int, int], max_err: dict[str, float]) -> list[dict]:
    """The forward kernel on the 3D protocol's masks (B = 16, N = 8): against
    its plain version at the denoiser's two head widths in bf16 and f32 (the
    existing tolerances and exact zeros on empty rows), then timed in bf16
    (``time_forward_on_mask``)."""
    import torch

    # all pairs of each object's valid parts: padding parts have empty rows and unattended keys
    mask = first_batch_3d(protocol).adj.contiguous()
    b, n, _ = mask.shape
    pairs = int(mask.sum())
    label = "3D protocol, first call"
    phase(f"3D masks: B={b} N={n}, {int((~mask.any(-1)).sum())} empty query rows (padding parts), "
          f"{pairs} attended pairs ({pairs / mask.numel():.3f} of B·N²)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dh in widths:
        for dtype in (torch.bfloat16, torch.float32):
            _check_kernels(label, mask, dh, dtype, gen, max_err, backward=False)
    return time_forward_on_mask(mask, label, heads, widths, gen)


def time_forward_on_mask(mask, label: str, heads: int, widths, gen) -> list[dict]:
    """The forward kernel timed on ``mask`` at each head width in bf16,
    beside its plain version, the bound over the mask's attended pairs and
    ``scaled_dot_product_attention`` with the same boolean mask: one row a
    width; the caller adds its launches."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    b, n, _ = mask.shape
    pairs = int(mask.sum())
    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dh in widths:
        q, k, v = (torch.randn((b, n, heads, dh), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        with torch.no_grad():
            library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask[:, None]))
        ms = cuda_ms(lambda: ca.masked_attention_fwd(q, k, v, mask))
        plain_ms = cuda_ms(lambda: ca.masked_attention_fwd_plain(q, k, v, mask))
        bound, bound_by = bound_ms("masked_attention_fwd", b, n, heads, dh, 2, pairs=pairs)
        route = ca.route("masked_attention_fwd", q, k, v, mask)
        rows.append({"kernel": "masked_attention_fwd", "b": b, "n": n, "dh": dh, "route": route, "main_path": True,
                     "mask": label, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by})
        phase(f"timing masked_attention_fwd      B={b} N={n} H={heads} Dh={dh:3d} bf16 {route:12s} ({label}): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
              f"bound {bound:.6f} ms ({bound_by})")
    return rows


def _finite(m: dict) -> bool:
    return all(math.isfinite(v) for v in m.values() if isinstance(v, float)) and all(
        _finite(v) for v in m.values() if isinstance(v, dict))


def cli_evaluate_3d(run_dir: Path, model, cfg, step: int, protocol: dict):
    """A trained model written as a run of the port (config.json and a
    checkpoint of ``train/checkpoint.py``) and evaluated by
    ``cli/train_3d.py``'s ``run_3d --evaluate`` over the protocol's corpus
    in calls of its batch: (the CLI's metrics, seconds, launches, launches by
    route), the launches counted from 0."""
    import argparse

    import torch

    from diffassemble_tpu_torch.cli import train_3d
    from diffassemble_tpu_torch.train.checkpoint import CheckpointManager
    from diffassemble_tpu_torch.train.train_state import TrainState

    ckpt = CheckpointManager(run_dir / "checkpoints", monitor="rmse_t_AVG", mode="min")
    ckpt.save_config(cfg)
    ckpt.save(step, TrainState(dict(model.named_parameters()), {}, step,
                               torch.Generator(device="cuda").manual_seed(0)))
    ap = argparse.ArgumentParser()
    train_3d.add_3d_args(ap)
    p = protocol
    args = ap.parse_args([
        "--dataset", "synthetic", "--evaluate", "true", "--run_dir", str(run_dir),
        "--test_n", str(p["test_n"]), "--batch_size", str(p["batch"]), "--num_points", str(p["num_points"]),
        "--max_num_part", str(p["max_num_part"]), "--min_num_part", str(p["min_num_part"]),
        "--wall_detail", str(p["wall_detail"]), "--wall_boost", str(p["wall_boost"]),
        "--wall_surface", str(int(p.get("wall_surface", 0))), "--wall_freq", str(p.get("wall_freq", 14.0)),
        "--synthetic_canonical", str(p["canonical"]), "--seed", str(p["seed"]), "--device", "cuda"])
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    cli = train_3d.run_3d(args)
    torch.cuda.synchronize()
    return cli, time.perf_counter() - start, read_counts(), read_routes()


def timed_protocol_3d(model, protocol: dict, ratio: int | None = None):
    """``heldout3d``'s protocol at ``ratio`` with each call timed by CUDA
    events and the host clock and its launches counted: (the row, the calls,
    the launches counted from 0, by route, the peak memory)."""
    import torch

    from diffassemble_tpu_torch.train.heldout3d import run_protocol

    calls = []
    sample = model.sample

    def timed_sample(*a, **kw):
        """``model.sample`` timed by CUDA events and the host clock, its launches counted."""
        torch.cuda.synchronize()
        before, before_routes, host = read_counts(), read_routes(), time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = sample(*a, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        calls.append({"objects": int(a[0].x0.shape[0]), "parts": int(a[0].node_mask.sum()),
                      "ms": ev[0].elapsed_time(ev[1]), "host_s": time.perf_counter() - host,
                      "launches": {k: v - before[k] for k, v in read_counts().items()},
                      "routes": routes_since(before_routes)})
        return out

    model.sample = timed_sample
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        result = run_protocol(model, protocol, ratio=ratio)
    finally:
        model.sample = sample
    return result, calls, read_counts(), read_routes(), torch.cuda.max_memory_allocated()


def eval3d(workdir: Path, max_err: dict[str, float]) -> tuple[dict, dict, dict, list[dict]]:
    """The sixth main path: the trained 3D SE(3) model (``weights/diffusion3d_easy``
    at step 12000, bf16, committed converted as ``ASSET_3D``) under
    ``scripts/tpu_eval_3d.py``'s held-out protocol.

    The forward kernel is checked and timed on the protocol's masks first
    (``kernels_3d``). The asset is written as a run of the port (config.json
    and a checkpoint of ``train/checkpoint.py``), which ``cli/train_3d.py``'s
    ``run_3d --evaluate`` evaluates through ``Trainer.evaluate`` with the
    fragment adapter in calls of 16; then ``heldout3d_eval`` runs the protocol
    itself over the 64 objects in 4 calls of 16. Each run has its launches
    counted from 0: exactly 120 forward launches a call (4 layers × 30 steps),
    90 on the tensor cores (Dh 32) and 30 on the CUDA cores (Dh 264, the
    tensor-core route for that width is ROADMAP K3), no backward launch. The
    phase fails unless those hold, n_parts is 318, every metric is finite and
    rmse_t, rmse_r and part_acc@0.05 lie within ``TOL_3D`` of the JAX
    package's CPU run in bf16. The TPU's figures are printed beside the
    card's, ungated. Returns the launches of the protocol run, by kernel and
    by route, the result, and the kernel rows."""
    from diffassemble_tpu_torch.train.heldout3d import model_from_asset

    start = time.perf_counter()
    model, cfg, protocol, step = model_from_asset(ASSET_3D, "cuda")
    heads = cfg.heads
    widths = (cfg.hidden_dim // heads, (model.feat_dim + 64) // heads)
    rows = kernels_3d(protocol, heads, widths, max_err)
    per_call = cfg.n_layers * (cfg.steps // cfg.inference_ratio)
    n_calls = -(-protocol["test_n"] // protocol["batch"])
    want_routes = {"tensor_cores": (cfg.n_layers - 1) * (cfg.steps // cfg.inference_ratio),
                   "cuda_cores": cfg.steps // cfg.inference_ratio}
    phase(f"3D model loaded from {ASSET_3D.name} (step {step}, {sum(v.numel() for v in model.parameters())} "
          f"parameters, {cfg.compute_dtype}, backbone {cfg.backbone}, head widths {widths}) in "
          f"{time.perf_counter() - start:.2f} s")

    counts, routes, out, calls_by_ratio = protocol_runs_3d(workdir / "run3d", model, cfg, step, protocol,
                                                           "diffusion3d_easy")
    calls = calls_by_ratio[protocol["ratio"]]
    if len({r["route"] for r in rows}) != len(rows):
        raise AssertionError(f"3D held-out: the head widths {widths} share a route, so its launches do not split")
    for r in rows:  # each head width takes its own route: the protocol's launches a call on that route
        r["launches_per_3d_call"] = [c["routes"]["masked_attention_fwd"][r["route"]] for c in calls]
    return counts, routes, out, rows


def _headline(row: dict) -> dict[str, float]:
    """The gated and printed figures of a ``heldout3d`` row, flat."""
    out = {"rmse_t": row["rmse_t"], "rmse_r": row["rmse_r"], "gd_r": row["gd_r"],
           "part_acc@0.01": row["part_acc"]["0.01"], "part_acc@0.05": row["part_acc"]["0.05"],
           "gauge gd_r": row["gauge_aligned"]["gd_r"], "gauge rmse_t": row["gauge_aligned"]["rmse_t"]}
    if "refined" in row:
        r = row["refined"]
        out.update({"refined rmse_t": r["rmse_t"], "refined rmse_r": r["rmse_r"], "refined gd_r": r["gd_r"],
                    "refined part_acc@0.05": r["part_acc"]["0.05"]})
    return out


def protocol_runs_3d(run_dir: Path, model, cfg, step: int, protocol: dict, name: str):
    """A trained 3D checkpoint ``name`` through both entry points: the CLI's
    ``run_3d --evaluate`` (``cli_evaluate_3d``) at its config's ratio, then
    ``heldout3d``'s protocol at each of its ratios (``timed_protocol_3d``),
    and the metric's calibration rows. Each run has its launches counted from
    0: the denoiser's layers × reverse steps forward launches a call, one
    layer's on the CUDA cores and the others' on the tensor cores, no
    backward launch. Gates: those launches, n_parts (``N_PARTS_3D_ASSETS``),
    finite metrics, the zero-noise calibration row at part_acc 1.0, and each
    key of ``TOL_3D_ASSETS`` that the row has within its tolerance of the
    JAX package's CPU run in the checkpoint's type (``JAX_CPU_3D_ASSETS``).
    Returns the protocol runs' launches, by route, the result, and each
    ratio's calls."""
    from diffassemble_tpu_torch.train.heldout3d import calibration, protocol_corpus, protocol_ratios

    n_calls = -(-protocol["test_n"] // protocol["batch"])

    def want(ratio):
        steps = cfg.steps // ratio
        return cfg.n_layers * steps, {"tensor_cores": (cfg.n_layers - 1) * steps, "cuda_cores": steps}

    per_call, want_routes = want(cfg.inference_ratio)
    cli, cli_seconds, cli_counts, cli_routes = cli_evaluate_3d(run_dir, model, cfg, step, protocol)
    phase(f"{name} run_3d --evaluate: {cli_seconds:.2f} s, launches {cli_counts}, forward by route "
          f"{cli_routes['masked_attention_fwd']}; rmse_t_AVG {cli['rmse_t_AVG'][0]!r}, rmse_r_AVG "
          f"{cli['rmse_r_AVG'][0]!r}, gd_r_AVG {cli['gd_r_AVG'][0]!r}, part_acc_AVG {cli['part_acc_AVG'][0]!r}")
    if cli_counts != {"masked_attention_fwd": n_calls * per_call, "masked_attention_bwd_dq": 0,
                      "masked_attention_bwd_dkv": 0}:
        raise AssertionError(f"{name} run_3d: launches {cli_counts}, expected {n_calls * per_call} forward and "
                             f"no backward")
    if cli_routes["masked_attention_fwd"] != {r: n_calls * c for r, c in want_routes.items()}:
        raise AssertionError(f"{name} run_3d: forward launches by route {cli_routes['masked_attention_fwd']}")
    if not all(math.isfinite(m) for m, _ in cli.values()):
        raise AssertionError(f"{name} run_3d: a metric is not finite: {cli}")

    calib = calibration(protocol_corpus(protocol), protocol["batch"], protocol["max_num_part"], protocol["seed"],
                        "cuda")
    phase(f"{name} calibration (true poses under known noise): "
          + "; ".join(f"{r['rot_deg']}°/{r['trans_sigma']}: part_acc@0.01 {r['part_acc']['0.01']:.4f} "
                      f"@0.05 {r['part_acc']['0.05']:.4f}, CD median {r['cd_median']:.3e}" for r in calib))
    if calib[0]["rot_deg"] or calib[0]["trans_sigma"] or set(calib[0]["part_acc"].values()) != {1.0}:
        raise AssertionError(f"{name} calibration: the true poses do not score part_acc 1.0: {calib[0]}")

    counts = dict.fromkeys(KERNEL_SOURCES, 0)
    routes = {k: dict.fromkeys(("tensor_cores", "cuda_cores"), 0) for k in KERNEL_SOURCES}
    out, calls_by_ratio = {"cli": {k: m for k, (m, _) in cli.items()}, "cli_seconds": cli_seconds,
                           "cli_launches": cli_counts, "cli_routes": cli_routes, "calibration": calib,
                           "rows": []}, {}
    for ratio in protocol_ratios(protocol):
        ratio = ratio or cfg.inference_ratio
        per_call, want_routes = want(ratio)
        result, calls, c_counts, c_routes, peak = timed_protocol_3d(model, protocol, ratio)
        for k in KERNEL_SOURCES:
            counts[k] += c_counts[k]
            for r in routes[k]:
                routes[k][r] += c_routes[k][r]
        for c in calls:
            phase(f"{name} held-out call, ratio {ratio}, {c['objects']} objects ({c['parts']} parts): "
                  f"{c['ms']:.2f} ms (CUDA events), {c['host_s']:.3f} s host, launches {c['launches']}, forward by "
                  f"route {c['routes']['masked_attention_fwd']}")
            if c["launches"] != {"masked_attention_fwd": per_call, "masked_attention_bwd_dq": 0,
                                 "masked_attention_bwd_dkv": 0} or c["routes"]["masked_attention_fwd"] != want_routes:
                raise AssertionError(f"{name} held-out call: launches {c['launches']} by route {c['routes']}, "
                                     f"expected {per_call} forward ({want_routes}) and no backward")
        if len(calls) != n_calls:
            raise AssertionError(f"{name} held-out: {len(calls)} calls, expected {n_calls}")
        card = _headline(result)
        refs = JAX_CPU_3D_ASSETS[name][ratio]  # a ratio without the JAX package's figures fails here
        ref = refs[cfg.compute_dtype]
        tpu = TPU_3D_ASSETS.get(name, {}).get(ratio, {})
        for key, value in card.items():
            gated = key in TOL_3D_ASSETS[name] and key in ref
            phase(f"{name} ratio {ratio} {key:22s}: card {value!r}  JAX CPU {cfg.compute_dtype} {ref.get(key)!r}  "
                  f"JAX CPU float32 {refs.get('float32', {}).get(key)!r}  TPU {tpu.get(key)!r}"
                  + (f"  |card - JAX CPU| {abs(value - ref[key]):.5f} (tolerance {TOL_3D_ASSETS[name][key]})"
                     if gated else "  (printed, ungated)"))
        phase(f"{name} ratio {ratio}: n_parts {result['n_parts']}, part_acc {result['part_acc']}, CD percentiles "
              f"{result['cd_percentiles']}, gauge-aligned {result['gauge_aligned']}"
              + (f", refined {result['refined']}" if "refined" in result else "")
              + f"; max_memory_allocated {peak / 2**30:.2f} GiB")
        within = {key: abs(card[key] - ref[key]) <= tol for key, tol in TOL_3D_ASSETS[name].items()
                  if key in card and key in ref}
        if result["n_parts"] != N_PARTS_3D_ASSETS[name] or not _finite(result) or not all(within.values()):
            raise AssertionError(f"{name} held-out gate, ratio {ratio}: n_parts {result['n_parts']} (expected "
                                 f"{N_PARTS_3D_ASSETS[name]}), within tolerance {within}, result {result}")
        ms = [c["ms"] for c in calls]
        out["rows"].append({**result, "calls": calls, "ms_per_call": sum(ms) / len(ms), "max_memory_allocated": peak})
        calls_by_ratio[ratio] = calls
    out.update({k: v for k, v in out["rows"][0].items()})  # the first ratio's row at the top, as before
    phase(f"{name}: {sum(len(c) for c in calls_by_ratio.values())} held-out calls, launches {counts}, by route "
          f"{routes['masked_attention_fwd']}; the CLI's rmse_t_AVG {cli['rmse_t_AVG'][0]!r} against the protocol's "
          f"{out['rmse_t']!r}")
    return counts, routes, out, calls_by_ratio


def train3d_args(run_dir: str, *extra: str, flags: list[str] = TRAIN3D_FLAGS):
    """``cli/train_3d.py``'s arguments for a 3D training run (default: the
    easy run's, ``TRAIN3D_FLAGS``) in ``run_dir``, the encoder_init in this
    checkout."""
    import argparse

    from diffassemble_tpu_torch.cli import train_3d

    ap = argparse.ArgumentParser()
    train_3d.add_3d_args(ap)
    args = ap.parse_args([*flags, "--run_dir", run_dir, *extra])
    if args.encoder_init:
        args.encoder_init = str(ROOT / args.encoder_init)
    return args


def loss_inputs_3d(args=None):
    """A loss check's inputs on the host: a 3D run's first training batch as
    ``Trainer.fit`` draws it (default: the easy run's, 16 objects, 8 parts of
    512 points), and the loss's draws, numpy from ``LOSS3D_SEED`` in this
    order: t (16,), the translation noise (16, 8, 3), the IGSO3 quantiles
    (16, 8) and axes (16, 8, 3)."""
    import numpy as np

    from diffassemble_tpu_torch.cli import train_3d
    from diffassemble_tpu_torch.train.trainer import batch_iterator, fragment_adapter

    args = args or train3d_args("")
    train_ds, _, cats = train_3d.datasets_3d(args)
    adapter = fragment_adapter(args.max_num_part, cats, seed=args.seed)
    adapter.collate([train_ds[0]], args.max_num_part)  # as fit does first
    nb = next(iter(batch_iterator(train_ds, args.batch_size, args.max_num_part, np.random.default_rng(args.seed),
                                  collate=adapter.collate)))
    rng = np.random.default_rng(LOSS3D_SEED)
    b, p = nb.x0.shape[:2]
    draws = {"t_graph": rng.integers(0, 300, b), "noise_tr": rng.standard_normal((b, p, 3), dtype=np.float32),
             "rot_u": rng.random((b, p), dtype=np.float32),
             "rot_axes": rng.standard_normal((b, p, 3), dtype=np.float32)}
    return nb, draws


def trained_loss_3d(compute_dtype: str, device: str = "cuda") -> dict[str, float]:
    """The loss dict of the trained 3D weights (``ASSET_3D``) in
    ``compute_dtype`` on ``loss_inputs_3d``."""
    import torch

    from diffassemble_tpu_torch.train.heldout3d import model_from_asset

    nb, draws = loss_inputs_3d()
    model, _, _, _ = model_from_asset(ASSET_3D, device, compute_dtype)
    with torch.no_grad():
        _, out = model.loss(nb.to(device), **{k: torch.as_tensor(v, device=device) for k, v in draws.items()})
    return {k: float(v) for k, v in out.items()}


def train3d_kernels(nb, widths: tuple[int, int], max_err: dict[str, float]) -> list[dict]:
    """The three kernels on the 3D training masks (the run's first batch: B =
    16, N = 8, padding parts with empty query rows and unattended keys): dQ
    and dK/dV, after the forward, against their plain versions at the
    denoiser's head widths, Dh 32 (tensor cores) and 264 (CUDA cores), in
    bf16 and f32 with phase 3's tolerances, exact zeros and routes; then all
    three timed (``time_on_masks``)."""
    import torch

    mask = torch.as_tensor(nb.adj).cuda().contiguous()
    b, n, _ = mask.shape
    pairs = int(mask.sum())
    label = "3D training, first batch"
    phase(f"3D training masks: B={b} N={n}, {int((~mask.any(-1)).sum())} empty query rows, "
          f"{int((~mask.any(-2)).sum())} unattended keys (padding parts), {pairs} attended pairs "
          f"({pairs / mask.numel():.3f} of B·N²)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dh in widths:
        for dtype in (torch.bfloat16, torch.float32):
            _check_kernels(label, mask, dh, dtype, gen, max_err)
    return time_on_masks(mask, label, widths, gen)


def trained_loss_check() -> dict[str, dict[str, float]]:
    """The training loss of the trained 3D weights on the card, in bf16 and
    f32, on the 3D run's first batch with the numpy draws
    (``loss_inputs_3d``), against the JAX package's CPU values for the same
    inputs (``JAX_CPU_LOSS_3D``): every term within ``TOL_LOSS_3D``'s
    relative tolerance of its type, the total within the tighter one."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        got, ref = trained_loss_3d(dtype), JAX_CPU_LOSS_3D[dtype]
        term_tol, total_tol = TOL_LOSS_3D[dtype]
        rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in ref}
        worst = max(rel[k] / (total_tol if k == "loss" else term_tol) for k in ref)
        phase(f"3D loss on the trained weights, {dtype}: total {got['loss']!r} (JAX CPU {ref['loss']!r}); "
              f"largest relative error {max(rel.values()):.2e} ({max(rel, key=rel.get)}), worst err/tol {worst:.3f}")
        if set(got) != set(ref) or not all(math.isfinite(v) for v in got.values()) or worst > 1.0:
            raise AssertionError(f"3D loss {dtype}: card {got} against JAX CPU {ref} (relative {rel})")
        out[dtype] = got
    return out


def gradient_parity_3d(nb, draws, model=None, label: str = "3D") -> None:
    """One full-width f32 loss and backward of ``model`` (default: the trained
    3D weights) on the run's first batch and the check's draws, with the
    kernels (each pass of the denoiser launches each kernel once a layer) and
    with plain attention (none): every gradient finite and within 1e-3 of its
    parameter's largest entry plus 1e-6 of the model's of the plain one
    (sums in another order through the denoiser's passes), and every query,
    key and value weight, the encoder, the relative-pose head (when the model
    has one) and the denoiser with a nonzero gradient."""
    import re

    import torch

    from diffassemble_tpu_torch.ops import attention
    from diffassemble_tpu_torch.train.heldout3d import model_from_asset

    if model is None:
        model, _, _, _ = model_from_asset(ASSET_3D, "cuda", "float32")
    cfg = model.cfg
    passes = 2 if cfg.aux_pose_weight > 0 else 1
    batch = nb.to("cuda")
    draws = {k: torch.as_tensor(v, device="cuda") for k, v in draws.items()}
    grads = []
    for swap in (False, True):
        model.zero_grad(set_to_none=True)
        ctx = mock.patch.object(attention, "MaskedAttention", PlainAttention) if swap else contextlib.nullcontext()
        with ctx:
            before = read_counts()
            loss, _ = model.loss(batch, **draws)
            loss.backward()
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in read_counts().items()}
        if launched != dict.fromkeys(KERNEL_SOURCES, 0 if swap else passes * cfg.n_layers):
            raise AssertionError(f"{label} gradients: launches {launched} (plain attention: {swap})")
        missing = [k for k, p in model.named_parameters() if p.grad is None]
        if missing:
            raise AssertionError(f"{label} gradients: no gradient reached {missing}")
        grads.append({k: p.grad.detach().clone() for k, p in model.named_parameters()})
    kern, plain = grads
    gmax = max(float(g.abs().max()) for g in plain.values())
    worst, worst_name = 0.0, ""
    for name, g in plain.items():
        err = float((kern[name] - g).abs().max())
        tol = 1e-3 * float(g.abs().max()) + 1e-6 * gmax
        if err / tol > worst:
            worst, worst_name = err / tol, name
        if not (bool(torch.isfinite(kern[name]).all()) and err <= tol):
            raise AssertionError(f"{label} {name}: kernel gradient differs from plain by {err:.3e} (tol {tol:.3e})")
    qkv = [n for n in kern if re.fullmatch(r"denoiser\.gnn\.layers\.\d+\.(conv\.)?(query|key|value)\.weight", n)]
    if len(qkv) != 3 * cfg.n_layers:
        raise AssertionError(f"{label} gradients: query/key/value weights {qkv}")
    smallest = min(float(kern[n].abs().max()) for n in qkv)
    groups = {g: max(float(v.abs().max()) for k, v in kern.items() if k.startswith(g + "."))
              for g in ("encoder", "rel_head", "denoiser") if any(k.startswith(g + ".") for k in kern)}
    if not (smallest > 0 and all(v > 0 for v in groups.values())):
        raise AssertionError(f"{label} gradients: a zero gradient (query/key/value {smallest}, groups {groups})")
    phase(f"{label} gradient parity f32, B={batch.x0.shape[0]} full width: kernels vs plain attention, "
          f"worst err/tol {worst:.3f} ({worst_name}) over {len(plain)} parameters; all finite, {len(qkv)} "
          f"query/key/value weights nonzero (smallest max|g| {smallest:.3e}), max|g| by part {groups}")


def drive_run_3d(argss: list, eval_every: int, label: str):
    """``run_3d`` without ``--evaluate`` on each of ``argss`` in turn (a run,
    then its resumes), every train step and evaluation timed and its launches
    counted, evaluating every ``eval_every`` steps (the CLI's is every 1000).
    The launches are counted from 0. Returns (the steps, the evaluations,
    (steps so far, checkpoints) after each run, seconds, peak memory)."""
    import torch

    from diffassemble_tpu_torch.cli import train_3d
    from diffassemble_tpu_torch.train import trainer as trainer_mod

    steps, evals, runs = [], [], []
    make_step = trainer_mod.make_train_step

    def counted_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def counted(state, batch):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t0, before, before_routes = time.perf_counter(), read_counts(), read_routes()
            ev[0].record()
            new, aux = step(state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            rec = {"step": new.step, "seconds": time.perf_counter() - t0, "ms": ev[0].elapsed_time(ev[1]),
                   "launches": {k: v - before[k] for k, v in read_counts().items()},
                   "routes": routes_since(before_routes), **{k: float(v) for k, v in aux.items()}}
            steps.append(rec)
            norms = ", ".join(f"{k[len('grad_norm/'):]} {v:.4f}" for k, v in rec.items() if k.startswith("grad_norm/"))
            phase(f"{label} train step {rec['step']}: {rec['seconds']:.3f} s host, {rec['ms']:.2f} ms CUDA events, "
                  f"launches {rec['launches']}, loss {rec['loss']:.4f}, grad_norm {rec['grad_norm']:.4f} ({norms})")
            return new, aux

        return counted

    class EvaluatedTrainer(trainer_mod.Trainer):
        """The CLI's ``Trainer``, evaluating every ``eval_every`` steps, each
        evaluation timed and counted."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.eval_every = eval_every

        def evaluate(self, params, eval_ds, max_batches=None, tag="val", step=0):
            torch.cuda.synchronize()
            t0, before, before_routes = time.perf_counter(), read_counts(), read_routes()
            metrics = super().evaluate(params, eval_ds, max_batches=max_batches, tag=tag, step=step)
            torch.cuda.synchronize()
            calls = min(max_batches or len(eval_ds), len(eval_ds) // self.batch_size)
            rec = {"tag": tag, "step": step, "calls": calls, "seconds": time.perf_counter() - t0,
                   "launches": {k: v - before[k] for k, v in read_counts().items()},
                   "routes": routes_since(before_routes), "rmse_t_AVG": metrics["rmse_t_AVG"]}
            evals.append(rec)
            phase(f"{label} {tag} evaluation at step {step}: {calls} call(s) of {self.batch_size} objects, "
                  f"{rec['seconds']:.3f} s, launches {rec['launches']}, rmse_t_AVG {rec['rmse_t_AVG']!r}")
            return metrics

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    with mock.patch.object(trainer_mod, "make_train_step", counted_make_train_step), \
            mock.patch.object(trainer_mod, "Trainer", EvaluatedTrainer):
        for args in argss:
            train_3d.run_3d(args)
            ckpt_dir = Path(args.run_dir) / "checkpoints"
            runs.append((len(steps), sorted(int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit())))
    return steps, evals, runs, time.perf_counter() - start, torch.cuda.max_memory_allocated()


def train3d(workdir: Path, max_err: dict[str, float]) -> tuple[dict[str, int], dict[str, dict[str, int]], dict,
                                                                 list[dict]]:
    """The seventh main path: 3D training. First (a) the backward kernels on
    the run's first batch's masks (``train3d_kernels``), (b) the trained
    weights' loss against the JAX package's CPU values, (c) kernel against
    plain-attention gradients. Then ``run_3d`` without ``--evaluate`` on the
    easy run's flags (``TRAIN3D_FLAGS``: vn_dgcnn_rich from its encoder_init,
    relative-pose conditioning, aux-pose and rot-pt-l2 losses, bf16, batch
    16, 512 points, up to 8 parts) from seeded weights: a sanity
    evaluation, 4 steps with an evaluation and a checkpoint at step 4, then a
    resume to step 6. Gates: every step exactly 8 launches of each kernel, 6
    on the tensor cores (Dh 32) and 2 on the CUDA cores (Dh 264), finite
    losses and gradient norms, nonzero gradients in the encoder, the pairwise
    head and the denoiser; every evaluation 120 forward launches a call of 16
    objects and no backward; the checkpoints and the resume. Returns the
    run's launches, by kernel and by route, its result and the kernel rows."""
    from diffassemble_tpu_torch.cli import train_3d

    start = time.perf_counter()
    nb, draws = loss_inputs_3d()
    cfg = train_3d.config_from_args(train3d_args(""))
    feat_dim = 2048  # vn_dgcnn_rich: [equivariant 1536 ‖ invariant 512]
    widths = (cfg.hidden_dim // cfg.heads, (feat_dim + 64) // cfg.heads)
    phase(f"3D training batch and draws made in {time.perf_counter() - start:.2f} s; head widths {widths}")
    rows = train3d_kernels(nb, widths, max_err)
    losses = trained_loss_check()
    gradient_parity_3d(nb, draws)

    per_call = cfg.n_layers * (cfg.steps // cfg.inference_ratio)
    run_dir = workdir / "train3d"
    steps, evals, runs, seconds, peak = drive_run_3d(
        [train3d_args(str(run_dir), "--max_steps", str(TRAIN3D_STEPS)),
         train3d_args(str(run_dir), "--max_steps", str(TRAIN3D_RESUME_TO))], TRAIN3D_STEPS, "3D")
    first_run, first_ckpts = runs[0]
    counts, routes = read_counts(), read_routes()
    ckpts = sorted(int(p.name) for p in (run_dir / "checkpoints").iterdir() if p.name.isdigit())

    step_want = dict.fromkeys(KERNEL_SOURCES, 2 * cfg.n_layers)
    route_want = dict.fromkeys(KERNEL_SOURCES, {"tensor_cores": 2 * (cfg.n_layers - 1), "cuda_cores": 2})
    if first_run != TRAIN3D_STEPS or [s["step"] for s in steps] != list(range(1, TRAIN3D_RESUME_TO + 1)):
        raise AssertionError(f"3D training: steps {[s['step'] for s in steps]}, the first run {first_run}")
    for s in steps:
        if s["launches"] != step_want or s["routes"] != route_want:
            raise AssertionError(f"3D train step {s['step']}: launches {s['launches']} by route {s['routes']}, "
                                 f"expected {step_want}, {route_want}")
        if not (all(math.isfinite(v) for k, v in s.items() if isinstance(v, float)) and s["grad_nonfinite"] == 0
                and min(s["grad_norm/encoder"], s["grad_norm/rel_head"], s["grad_norm/denoiser"]) > 0):
            raise AssertionError(f"3D train step {s['step']}: bad loss or gradient norms {s}")
    for e in evals:
        n = per_call * e["calls"]
        if (e["calls"] != 1 or e["launches"] != {"masked_attention_fwd": n, "masked_attention_bwd_dq": 0,
                                                 "masked_attention_bwd_dkv": 0}
                or e["routes"]["masked_attention_fwd"] != {"tensor_cores": n * 3 // 4, "cuda_cores": n // 4}):
            raise AssertionError(f"3D evaluation: {e}, expected {per_call} forward launches a call (3/4 on the "
                                 f"tensor cores) and no backward")
    if [(e["tag"], e["step"]) for e in evals] != [("sanity", 0), ("val", TRAIN3D_STEPS), ("sanity", 0)]:
        raise AssertionError(f"3D evaluations {[(e['tag'], e['step']) for e in evals]}")
    if first_ckpts != [TRAIN3D_STEPS] or ckpts != [TRAIN3D_STEPS, TRAIN3D_RESUME_TO]:
        raise AssertionError(f"3D checkpoints {first_ckpts}, then {ckpts}")
    for kernel in KERNEL_SOURCES:
        if len({r["route"] for r in rows if r["kernel"] == kernel}) != len(widths):
            raise AssertionError(f"3D training: {kernel} at the head widths {widths} shares a route, so its "
                                 f"launches do not split by width")
    for r in rows:  # each head width takes its own route: each step's launches on that route
        r["launches_per_step"] = [s["routes"][r["kernel"]][r["route"]] for s in steps]
    saved = json.loads((run_dir / "checkpoints" / "config.json").read_text())
    if saved["backbone"] != "vn_dgcnn_rich" or not saved["rel_condition"] or saved["hidden_dim"] != 256:
        raise AssertionError(f"3D config.json {saved}")
    steady = [s for i, s in enumerate(steps) if i not in (0, first_run)]
    result = {"seconds": seconds, "steady_host_s": [s["seconds"] for s in steady],
              "steady_cuda_ms": [s["ms"] for s in steady], "first_step_s": [steps[0]["seconds"],
                                                                            steps[first_run]["seconds"]],
              "max_memory_allocated": peak, "checkpoints": ckpts, "losses": [s["loss"] for s in steps],
              "eval_seconds": [e["seconds"] for e in evals], "rmse_t_AVG": [e["rmse_t_AVG"] for e in evals],
              "trained_loss": losses}
    phase(f"3D training: {len(steps)} steps in two runs, {seconds:.1f} s with evaluations and checkpoints; steady "
          f"s/step by host clock {_spread(result['steady_host_s'])}, by CUDA events (ms) "
          f"{_spread(result['steady_cuda_ms'])}; first steps {[round(x, 3) for x in result['first_step_s']]} s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; checkpoints {first_ckpts} then {ckpts}; losses "
          f"{[round(x, 4) for x in result['losses']]}; launches {counts}, by route {routes}")
    return counts, routes, result, rows


def asset_protocol_3d(name: str) -> dict:
    """A committed 3D asset's protocol, read without building its model."""
    import numpy as np

    from diffassemble_tpu_torch.train.heldout3d import ASSETS

    with np.load(ASSETS[name]) as z:
        return json.loads(str(z["protocol"]))


def kernels_3d_widths(max_err: dict[str, float]) -> list[dict]:
    """All three kernels at every head width the 3D family gives them, on the
    3D protocols' own masks: N = 8 (``diffusion3d_easy``'s first call, 2–8
    parts) and N = 20 (``diffusion3d_vndgcnn``'s, 2–20 parts: most rows are
    padding, with empty query rows and unattended keys), against their plain
    versions in bf16 and f32 with phase 3's tolerances, exact zeros and
    routes; then timed in bf16 where a main path launches them
    (``time_on_masks``): at N = 20 Dh 32 (every N = 20 path), 24
    (``pointnet``), 40 (``pointnet_plus``), 104 (``diffusion3d_vndgcnn``),
    136 (``pointnet_inv``) and 271 (``vnn``), at N = 8 Dh 136 (split message
    passing). Returns the timed rows, each with its mask's N."""
    import torch

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, timed in (("diffusion3d_easy", (136,)), ("diffusion3d_vndgcnn", (24, 32, 40, 104, 136, 271))):
        mask = first_batch_3d(asset_protocol_3d(name)).adj.contiguous()
        b, n, _ = mask.shape
        label = f"3D protocol {name}, first call"
        phase(f"3D masks, {name}: B={b} N={n}, {int((~mask.any(-1)).sum())} empty query rows, "
              f"{int((~mask.any(-2)).sum())} unattended keys, {int(mask.sum())} attended pairs")
        for dh in (32, *OTHER_HEAD_DIMS):
            for dtype in (torch.bfloat16, torch.float32):
                _check_kernels(label, mask, dh, dtype, gen, max_err)
        rows += time_on_masks(mask, label, timed, gen)
    return rows


def eval3d_more(workdir: Path) -> dict[str, tuple]:
    """The eighth main path: the three other trained 3D checkpoints
    (``MORE_ASSETS_3D``) through ``run_3d --evaluate`` and ``heldout3d``'s
    protocol (``protocol_runs_3d``): ``diffusion3d_relpose`` and
    ``diffusion3d_wallsurf`` (its refined row too) at ratio 10,
    ``diffusion3d_vndgcnn`` (N = 20, Dh 104 on the CUDA cores) at ratios 10
    and 2. Each checkpoint's two head widths must take two routes. Returns,
    by asset, (launches, by route, the result, the calls by ratio, the head
    widths, N)."""
    from diffassemble_tpu_torch.ops import cuda_attention as ca
    from diffassemble_tpu_torch.train.heldout3d import model_from_asset

    import torch

    out = {}
    for name in MORE_ASSETS_3D:
        start = time.perf_counter()
        model, cfg, protocol, step = model_from_asset(name, "cuda")
        widths = (cfg.hidden_dim // cfg.heads, (model.feat_dim + 64) // cfg.heads)
        probe = [torch.zeros((1, cfg.max_num_part, cfg.heads, w), dtype=torch.bfloat16, device="cuda")
                 for w in widths]
        mask = torch.ones((1, cfg.max_num_part, cfg.max_num_part), dtype=torch.bool, device="cuda")
        routes_of = {ca.route("masked_attention_fwd", t, t, t, mask) for t in probe}
        phase(f"{name} loaded (step {step}, {sum(v.numel() for v in model.parameters())} parameters, "
              f"{cfg.compute_dtype}, backbone {cfg.backbone}, N {cfg.max_num_part}, head widths {widths} on "
              f"{sorted(routes_of)}) in {time.perf_counter() - start:.2f} s")
        if len(routes_of) != len(widths):
            raise AssertionError(f"{name}: the head widths {widths} share a route, so its launches do not split")
        counts, routes, result, calls = protocol_runs_3d(workdir / f"run_{name}", model, cfg, step, protocol, name)
        out[name] = (counts, routes, result, calls, widths, cfg.max_num_part)
        del model
        torch.cuda.empty_cache()
    return out


def card_vs_cpu_loss_3d(args, nb, draws, label: str) -> dict[str, float]:
    """The f32 loss dict of the configuration's seeded weights (with its
    encoder_init) on the card and on the CPU, on the first ``LOSS_CPU_OBJECTS``
    objects of the batch with the same draws: each term within
    ``TOL_LOSS_3D["float32"]``'s relative tolerance, the total within the
    tighter one. Returns the card's dict."""
    import dataclasses

    import torch

    from diffassemble_tpu_torch.cli import train_3d
    from diffassemble_tpu_torch.models import Diffusion3D

    cfg = dataclasses.replace(train_3d.config_from_args(args), compute_dtype="float32")
    small = type(nb)(*[a[:LOSS_CPU_OBJECTS] for a in nb])
    got = {}
    for device in ("cpu", "cuda"):
        model = Diffusion3D(cfg, device=device, seed=args.seed)
        model.init(args.seed)
        with torch.no_grad():
            _, out = model.loss(small.to(device), **{k: torch.as_tensor(v[:LOSS_CPU_OBJECTS], device=device)
                                                     for k, v in draws.items()})
        got[device] = {k: float(v) for k, v in out.items()}
    term_tol, total_tol = TOL_LOSS_3D["float32"]
    card, cpu = got["cuda"], got["cpu"]
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    worst = max(rel[k] / (total_tol if k == "loss" else term_tol) for k in cpu)
    phase(f"{label} loss f32, card vs CPU, {LOSS_CPU_OBJECTS} objects, seeded weights: total {card['loss']!r} vs "
          f"{cpu['loss']!r}; largest relative error {max(rel.values()):.2e} ({max(rel, key=rel.get)}), worst "
          f"err/tol {worst:.3f}")
    if set(card) != set(cpu) or not all(math.isfinite(v) for v in card.values()) or worst > 1.0:
        raise AssertionError(f"{label} loss f32: card {card} against CPU {cpu} (relative {rel})")
    return card


def _check_steps_3d(label: str, cfg, steps: list[dict], evals: list[dict], width: int) -> None:
    """Each step: the denoiser's passes × layers launches of each kernel,
    one layer's (head width ``width``) on the CUDA cores and the others' on
    the tensor cores; finite losses and gradient norms, every group's
    gradient nonzero. Each evaluation: one call, the layers × reverse steps
    forward launches, no backward."""
    passes = 2 if cfg.aux_pose_weight > 0 else 1
    step_want = dict.fromkeys(KERNEL_SOURCES, passes * cfg.n_layers)
    route_want = dict.fromkeys(KERNEL_SOURCES, {"tensor_cores": passes * (cfg.n_layers - 1), "cuda_cores": passes})
    for s in steps:
        if s["launches"] != step_want or s["routes"] != route_want:
            raise AssertionError(f"{label} step {s['step']}: launches {s['launches']} by route {s['routes']}, "
                                 f"expected {step_want}, {route_want} (Dh {width} on the CUDA cores)")
        norms = [v for k, v in s.items() if k.startswith("grad_norm/")]
        if not (all(math.isfinite(v) for v in s.values() if isinstance(v, float)) and s["grad_nonfinite"] == 0
                and len(norms) >= 2 and min(norms) > 0):
            raise AssertionError(f"{label} step {s['step']}: bad loss or gradient norms {s}")
    reverse = cfg.steps // cfg.inference_ratio
    per_call = cfg.n_layers * reverse
    for e in evals:
        if (e["calls"] != 1 or e["launches"] != {"masked_attention_fwd": per_call, "masked_attention_bwd_dq": 0,
                                                 "masked_attention_bwd_dkv": 0}
                or e["routes"]["masked_attention_fwd"] != {"tensor_cores": (cfg.n_layers - 1) * reverse,
                                                           "cuda_cores": reverse}):
            raise AssertionError(f"{label} evaluation: {e}, expected {per_call} forward launches a call")


def train3d_more(workdir: Path) -> dict[str, tuple]:
    """The ninth main path: 3D training with the other encoders and split
    message passing, through ``run_3d`` without ``--evaluate``. First the
    full-width ``pointnet`` run (``TRAIN3D_POINTNET_FLAGS``: the
    configuration of ``results/quality-3d-pointnet``, N = 20, batch 16 of
    1000 points, from ``weights/pointnet_pose3d.npz``): 3 steps with an
    evaluation and a checkpoint at step 3, then a resume to step 4. Then one
    step each of ``TRAIN3D_ONE_STEP``: ``pointnet_inv``, ``pointnet_plus`` and
    ``vnn`` at the same widths, and ``vn_dgcnn`` with ``--equiv_inv_mp 1`` on
    the easy run's corpus (N = 8). For each configuration, before its run,
    the f32 loss of its seeded weights on the card against the CPU
    (``card_vs_cpu_loss_3d``), and for ``vnn`` (Dh 271) and the split
    message passing (Dh 136, keys and values from the second stream) the
    f32 gradients with the kernels against plain attention. Gates
    (``_check_steps_3d``): launches by route, finite losses and gradient
    norms, the checkpoints and the resume. Returns, by configuration,
    (launches, by route, the result, the two head widths, N)."""
    import dataclasses

    import torch

    from diffassemble_tpu_torch.cli import train_3d
    from diffassemble_tpu_torch.models import Diffusion3D

    out = {}
    for label, flags in {"pointnet": TRAIN3D_POINTNET_FLAGS, **TRAIN3D_ONE_STEP}.items():
        run_dir = workdir / f"train_{label}"
        args = train3d_args(str(run_dir), flags=flags)
        cfg = train_3d.config_from_args(args)
        start = time.perf_counter()
        nb, draws = loss_inputs_3d(args)
        model = Diffusion3D(cfg, device="cuda", seed=args.seed)
        width = (model.feat_dim + 64) // cfg.heads
        phase(f"{label}: first batch (B={nb.x0.shape[0]}, N={nb.x0.shape[1]}, {nb.pcds.shape[2]} points) and draws "
              f"made in {time.perf_counter() - start:.2f} s; backbone {model.cfg.backbone}, feature width "
              f"{model.feat_dim}, head widths ({cfg.hidden_dim // cfg.heads}, {width}), split message passing "
              f"{cfg.equiv_inv_mp}")
        losses = card_vs_cpu_loss_3d(args, nb, draws, label)
        if label in GRADIENT_PARITY_3D:
            f32 = Diffusion3D(dataclasses.replace(cfg, compute_dtype="float32"), device="cuda", seed=args.seed)
            f32.init(args.seed)
            gradient_parity_3d(nb, draws, f32, label)
            del f32
        del model
        torch.cuda.empty_cache()
        if label == "pointnet":
            argss = [train3d_args(str(run_dir), "--max_steps", str(TRAIN3D_POINTNET_STEPS), flags=flags),
                     train3d_args(str(run_dir), "--max_steps", str(TRAIN3D_POINTNET_RESUME_TO), flags=flags)]
        else:
            argss = [train3d_args(str(run_dir), "--max_steps", "1", flags=flags)]
        steps, evals, runs, seconds, peak = drive_run_3d(argss, TRAIN3D_POINTNET_STEPS, label)
        counts, routes = read_counts(), read_routes()
        _check_steps_3d(label, cfg, steps, evals, width)
        last = argss[-1].max_steps
        if [s["step"] for s in steps] != list(range(1, last + 1)) or runs[-1][1] != sorted(
                {*([TRAIN3D_POINTNET_STEPS] if label == "pointnet" else []), last}):
            raise AssertionError(f"{label}: steps {[s['step'] for s in steps]}, checkpoints after each run {runs}")
        saved = json.loads((run_dir / "checkpoints" / "config.json").read_text())
        if saved["backbone"] != cfg.backbone or saved["equiv_inv_mp"] != cfg.equiv_inv_mp:
            raise AssertionError(f"{label}: config.json {saved}")
        result = {"seconds": seconds, "max_memory_allocated": peak, "losses": [s["loss"] for s in steps],
                  "host_s": [s["seconds"] for s in steps], "cuda_ms": [s["ms"] for s in steps],
                  "evals": [(e["tag"], e["step"], e["rmse_t_AVG"]) for e in evals], "checkpoints": runs[-1][1],
                  "loss_f32_card": losses, "launches_per_step": [s["routes"] for s in steps]}
        phase(f"{label} training: {len(steps)} step(s) in {len(argss)} run(s), {seconds:.1f} s with evaluations and "
              f"checkpoints; s/step by host clock {[round(x, 3) for x in result['host_s']]}, CUDA events (ms) "
              f"{[round(x, 2) for x in result['cuda_ms']]}; max_memory_allocated {peak / 2**30:.2f} GiB; checkpoints "
              f"{runs[-1][1]}; losses {[round(x, 4) for x in result['losses']]}; launches {counts}, by route {routes}")
        out[label] = (counts, routes, result, (cfg.hidden_dim // cfg.heads, width), cfg.max_num_part)
    return out


def attach_launches_3d(rows: list[dict], e_more: dict, t_more: dict) -> list[dict]:
    """Each timed row of ``kernels_3d_widths`` gets ``launches_by_path``: for
    every main path of ``eval3d_more`` and ``train3d_more`` that runs its
    kernel at its head width and N, the launches on its route in each call
    or step (each width of a path takes its own route); a row that no main
    path runs gets ``main_path`` False."""
    for r in rows:
        kernel, route, by_path = r["kernel"], r["route"], {}
        for name, (_, _, _, calls, widths, n) in e_more.items():
            if kernel == "masked_attention_fwd" and n == r["n"] and r["dh"] in widths:
                for ratio, cs in calls.items():
                    by_path[f"eval3d_{name}_ratio{ratio}"] = [c["routes"][kernel][route] for c in cs]
        for label, (_, _, result, widths, n) in t_more.items():
            if n == r["n"] and r["dh"] in widths:
                by_path[f"train3d_{label}"] = [st[kernel][route] for st in result["launches_per_step"]]
        # the backward at Dh 104 runs on no main path (its checkpoint only evaluates): timed, not counted
        r["main_path"], r["launches_by_path"] = bool(by_path), by_path
    if not all(r["main_path"] for r in rows if r["kernel"] == "masked_attention_fwd"):
        raise AssertionError(f"a timed forward width runs on no main path: {[r for r in rows if not r['main_path']]}")
    return rows


def timed_sample_calls(cls):
    """(a patch of ``cls.sample``, the list it fills): within the patch every
    call is timed by CUDA events and the host clock and its launches counted,
    {"puzzles", "ms", "host_s", "routes"}."""
    import torch

    calls, sample = [], cls.sample

    def timed(self, batch, *args, **kwargs):
        host, before = time.perf_counter(), read_routes()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = sample(self, batch, *args, **kwargs)
        ev[1].record()
        torch.cuda.synchronize()
        calls.append({"puzzles": batch.patches.shape[0], "ms": ev[0].elapsed_time(ev[1]),
                      "host_s": time.perf_counter() - host, "routes": routes_since(before)})
        return out

    return mock.patch.object(cls, "sample", timed), calls


def attach_launches_2d(rows: list[dict], paths: dict[str, dict[str, list[dict]]]) -> list[dict]:
    """Each timed row of the equivariant 2D masks gets ``launches_by_path``:
    for the main paths that run its mask (``paths[mask label]``: path name →
    its calls or steps, each with measured launches by route), the launches
    of its kernel on its route in each call or step (both head widths
    together: 3 at Dh 32 and 1 at Dh 144 a denoiser pass). The mixed rows'
    mask is the mixed training corpus's first batch; rot_ms's held-out calls
    run the same sizes and padding over their own corpus."""
    for r in rows:
        r["launches_by_path"] = {path: [rec["routes"][r["kernel"]][r["route"]] for rec in recs]
                                 for path, recs in paths[r["mask"]].items()}
    return rows


def _gate_2d(name: str, metrics: dict, calls: list[dict], counts: dict, routes: dict, label: str) -> dict:
    """The trained checkpoint's gate: piece_acc within ``PIECE_ACC_TOL`` of the
    TPU's, every forward launch on the tensor cores, 120 a call, no backward."""
    per_call = 4 * (300 // 10)
    n = per_call * len(calls)
    if counts != {"masked_attention_fwd": n, "masked_attention_bwd_dq": 0, "masked_attention_bwd_dkv": 0} \
            or routes["masked_attention_fwd"] != {"tensor_cores": n, "cuda_cores": 0}:
        raise AssertionError(f"{label}: launches {counts} by route {routes}, expected {n} forward launches on the "
                             "tensor cores and no backward")
    from diffassemble_tpu_torch.train.heldout import asset_protocol

    tpu = TPU_2D[name]
    jax_cpu = json.loads(str(asset_protocol(name)[1]["jax_cpu_bfloat16"]))
    jax_cpu = {k: jax_cpu[k] for k in ("overall__piece_acc", "overall_acc")}
    gap = abs(metrics["overall__piece_acc"] - tpu["overall__piece_acc"])
    for c in calls:
        phase(f"{label} call of {c['puzzles']} puzzles: {c['ms']:.2f} ms (CUDA events), {c['host_s']:.3f} s host")
    sizes = {k[:-len("__piece_acc")]: (v, metrics[k[:-len("_piece_acc")] + "acc"]) for k, v in metrics.items()
             if k.endswith("__piece_acc") and not k.startswith("overall")}
    phase(f"{label} accuracy, bf16: piece_acc {metrics['overall__piece_acc']!r}, puzzle_acc "
          f"{metrics['overall_acc']!r} over {metrics['overall_nImages']:g} puzzles; (piece_acc, puzzle_acc) by "
          f"size {sizes}; the TPU's {tpu}, {gap:.5f} from the card's (tolerance {PIECE_ACC_TOL}); the JAX package's "
          f"CPU bf16 run {jax_cpu}")
    if metrics["overall_nImages"] != 64 or not gap <= PIECE_ACC_TOL:
        raise AssertionError(f"{label}: piece_acc {metrics['overall__piece_acc']} is not within {PIECE_ACC_TOL} of "
                             f"the TPU's {tpu['overall__piece_acc']}")
    return {"piece_acc": metrics["overall__piece_acc"], "puzzle_acc": metrics["overall_acc"], "by_size": sizes,
            "tpu": tpu, "jax_cpu_bfloat16": jax_cpu, "calls": calls}


def eval_rot_ms(workdir: Path) -> tuple[dict[str, int], dict[str, dict[str, int]], dict]:
    """The tenth main path: ``diffusion2d_rot_ms`` at step 7000 (committed
    converted, ``train/heldout.py:ASSETS``) through the recipe CLI
    (``cli/train_device.py --evaluate_npz``, ``evaluate_protocol``) under
    ``scripts/tpu_train_device.py``'s protocol as its run had it: data.json's
    corpus (sizes 6/8/10/12 padded to 144, fully connected, images from seed
    1000), the JAX rotation draw, calls of 16, bf16."""
    import torch

    from diffassemble_tpu_torch.cli import train_device
    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.train.heldout import ASSETS

    name = "diffusion2d_rot_ms"
    data_recipe = json.loads(MIXED_DATA.read_text())
    argv = recipe_argv(str(workdir / "rot_ms_eval"), data_recipe, 0, MIXED_BATCH, 64, 1, config=MIXED_CONFIG,
                       batch=MIXED_BATCH, ema_decay=0.0) + ["--eval_batch", str(MIXED_BATCH),
                                                            "--evaluate_npz", str(ASSETS[name])]
    patch, calls = timed_sample_calls(Diffusion2D)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    with patch:
        metrics = train_device.main(argv)
    seconds = time.perf_counter() - start
    counts, routes = read_counts(), read_routes()
    if len(calls) != 4 or (workdir / "rot_ms_eval").exists():
        raise AssertionError(f"rot_ms: {len(calls)} calls, or the evaluation wrote a run")
    result = _gate_2d(name, metrics, calls, counts, routes, "rot_ms")
    result.update(seconds=seconds, max_memory_allocated=torch.cuda.max_memory_allocated())
    phase(f"rot_ms: {seconds:.1f} s with the corpus; max_memory_allocated "
          f"{result['max_memory_allocated'] / 2**30:.2f} GiB; launches {counts}")
    return counts, routes, result


def eval_discrete() -> tuple[dict[str, int], dict[str, dict[str, int]], dict]:
    """The eleventh main path: ``diffusion2d_discrete_rot6`` at step 6000
    (committed converted) under ``scripts/tpu_train_variants.py``'s protocol
    (``train/heldout.py:run_protocol``: 64 6×6 puzzles, the committed 60%
    expander, the JAX rotation draw, calls of 32, bf16): 30 Gumbel steps a
    call, each re-running the equivariant encoder on the patches turned by
    the accumulated rotation."""
    import torch

    from diffassemble_tpu_torch.models import DiscreteDiffusion2DRot
    from diffassemble_tpu_torch.train.heldout import run_protocol

    name = "diffusion2d_discrete_rot6"
    patch, calls = timed_sample_calls(DiscreteDiffusion2DRot)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    with patch:
        metrics = run_protocol(name, "cuda")
    seconds = time.perf_counter() - start
    counts, routes = read_counts(), read_routes()
    if len(calls) != 2:
        raise AssertionError(f"discrete: {len(calls)} calls")
    result = _gate_2d(name, metrics, calls, counts, routes, "discrete")
    result.update(seconds=seconds, max_memory_allocated=torch.cuda.max_memory_allocated())
    phase(f"discrete: {seconds:.1f} s with the corpus; max_memory_allocated "
          f"{result['max_memory_allocated'] / 2**30:.2f} GiB; launches {counts}")
    return counts, routes, result


def discrete_masks():
    """(label, mask (32, 44, 44) bool on the card): the discrete protocol's
    committed 60% expander over 36 pieces plus 8 virtual nodes, shared by a
    call's 32 puzzles."""
    import torch

    from diffassemble_tpu_torch.ops.attention import build_adjacency_mask, extend_mask_with_virtual_nodes
    from diffassemble_tpu_torch.train.heldout import asset_adj, asset_protocol

    _, extras = asset_protocol("diffusion2d_discrete_rot6")
    valid = torch.ones((32, 36), dtype=torch.bool)
    adj, _ = extend_mask_with_virtual_nodes(build_adjacency_mask(torch.as_tensor(asset_adj(extras)), valid), valid, 8)
    return "discrete expander60%+8virt, B=32", adj.cuda().contiguous()


def kernels_discrete_masks(max_err: dict[str, float]) -> list[dict]:
    """The three kernels against their plain versions on the discrete
    protocol's masks (bf16 on the tensor cores, f32 on the CUDA cores, Dh 32
    and 144, exact zeros), then timed there (``time_on_masks``)."""
    import torch

    label, mask = discrete_masks()
    b, n, _ = mask.shape
    pairs = int(mask.sum())
    phase(f"discrete masks: {label}, B={b} N={n}, {pairs} attended pairs ({pairs / mask.numel():.3f} of B·N²)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dh in MAIN_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            _check_kernels(label, mask, dh, dtype, gen, max_err)
    return time_on_masks(mask, label, MAIN_HEAD_DIMS, gen)


def train_discrete(workdir: Path) -> tuple[dict[str, int], dict[str, dict[str, int]], dict]:
    """The twelfth main path: the discrete-rotation model of
    ``weights/diffusion2d_discrete_rot6``'s config (resnet18equiv, cold
    diffusion, the vb loss with the aux CE, bf16) through
    ``cli/train_2d_rot.py --discrete true`` at 6×6 over the 60% expander,
    batch 32, from seeded weights: a sanity evaluation, 2 steps, a
    checkpoint, a resume to step 3. Every step 4 + 4 + 4 tensor-core
    launches, finite losses, nonzero gradients; each sanity evaluation 120
    forward launches. First the seeded f32 loss on two puzzles, card against
    CPU on the same numpy draws (``card_vs_cpu_loss_2d``)."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch.models import DiscreteDiffusion2DConfig, DiscreteDiffusion2DRot

    from diffassemble_tpu_torch.train.heldout import asset_protocol

    cfg = DiscreteDiffusion2DConfig(**json.loads(str(asset_protocol("diffusion2d_discrete_rot6")[1]["config"])))
    f32 = dataclasses.replace(cfg, compute_dtype="float32", encoder_init="")
    rng = np.random.default_rng(LOSS3D_SEED)
    host = seeded_puzzles(6, 2, True, rng, degree="60%")
    draws = {"t_graph": rng.integers(0, cfg.steps, 2),
             "gumbel_x": -np.log(-np.log(rng.uniform(1e-12, 1.0, (2, 36, 36)))).astype(np.float32),
             "gumbel_r": -np.log(-np.log(rng.uniform(1e-12, 1.0, (2, 36, 4)))).astype(np.float32)}
    losses = card_vs_cpu_loss_2d(lambda device: DiscreteDiffusion2DRot(f32, device=device, seed=0), host, draws,
                                 "discrete")
    run_dir = workdir / "discrete"
    argv = [*DISCRETE_FLAGS, "--run_dir", str(run_dir)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    steps, runs = drive_trainer([argv + ["-max_steps", str(DISCRETE_STEPS)],
                                 argv + ["-max_steps", str(DISCRETE_RESUME_TO)]], "discrete")
    seconds = time.perf_counter() - start
    counts, routes = read_counts(), read_routes()
    peak = torch.cuda.max_memory_allocated()
    if runs != [DISCRETE_STEPS, DISCRETE_RESUME_TO - DISCRETE_STEPS] or \
            [s["step"] for s in steps] != list(range(1, DISCRETE_RESUME_TO + 1)):
        raise AssertionError(f"discrete training: steps {[s['step'] for s in steps]} in runs {runs}")
    _check_trainer_steps(steps, "discrete")
    per_call = cfg.n_layers * (cfg.steps // cfg.inference_ratio)
    in_steps = {k: sum(s["launches"][k] for s in steps) for k in KERNEL_SOURCES}
    sanity = {k: counts[k] - in_steps[k] for k in KERNEL_SOURCES}  # one sanity call in each run
    if sanity != {"masked_attention_fwd": 2 * per_call, "masked_attention_bwd_dq": 0,
                  "masked_attention_bwd_dkv": 0} or routes["masked_attention_fwd"]["cuda_cores"]:
        raise AssertionError(f"discrete training: sanity evaluations launched {sanity}, by route {routes}")
    saved = json.loads((run_dir / "checkpoints" / "config.json").read_text())
    ckpts = sorted(int(p.name) for p in (run_dir / "checkpoints").iterdir() if p.name.isdigit())
    if ckpts != [DISCRETE_RESUME_TO] or saved["n_classes"] != 36 or not saved["cold_diffusion"] \
            or saved["discrete_loss"] != "vb":
        raise AssertionError(f"discrete training: checkpoints {ckpts}, config {saved}")
    steady = [s for i, s in enumerate(steps) if i not in (0, runs[0])]
    result = {"seconds": seconds, "max_memory_allocated": peak, "losses": [s["total_loss"] for s in steps],
              "host_s": [s["seconds"] for s in steps], "cuda_ms": [s["ms"] for s in steps],
              "steady_host_s": [s["seconds"] for s in steady], "checkpoints": ckpts, "loss_f32_card": losses,
              "steps": steps}
    phase(f"discrete training: {len(steps)} steps in two runs, {seconds:.1f} s with sanity evaluations and "
          f"checkpoints; s/step by host clock {[round(x, 3) for x in result['host_s']]}, CUDA events (ms) "
          f"{[round(x, 2) for x in result['cuda_ms']]}; max_memory_allocated {peak / 2**30:.2f} GiB; losses "
          f"{[round(x, 4) for x in result['losses']]}; launches {counts}")
    return counts, routes, result


def _check_trainer_steps(steps: list[dict], label: str) -> None:
    """Every step 4 + 4 + 4 launches on the tensor cores, finite, with gradients in encoder and denoiser."""
    want = dict.fromkeys(KERNEL_SOURCES, 4)
    on_tc = dict.fromkeys(KERNEL_SOURCES, {"tensor_cores": 4, "cuda_cores": 0})
    for s in steps:
        if s["launches"] != want or s["routes"] != on_tc:
            raise AssertionError(f"{label} step {s['step']}: launches {s['launches']} by route {s['routes']}")
        if not (math.isfinite(s["total_loss"]) and math.isfinite(s["grad_norm"]) and s["grad_nonfinite"] == 0
                and s["grad_norm/encoder"] > 0 and s["grad_norm/denoiser"] > 0):
            raise AssertionError(f"{label} step {s['step']}: bad loss or gradient norms {s}")


def angle_sample() -> tuple[dict[str, int], dict[str, dict[str, int]], dict]:
    """The fourteenth main path: a seeded 6×6 ``AngleDiffusion2D`` sample
    (rot_ms's widths and encoder, DDIM from unit noise drawn on the CPU).
    First in f32, card against CPU within the 6×6 sample phase's 1e-3 (a
    comparison: its launches, on the CUDA cores as f32 asks, do not count);
    then in bf16 with the counts from 0: 120 forward launches on the tensor
    cores, no backward, a finite (1, 36, 4) result."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch.models import AngleDiffusion2D, AngleDiffusion2DConfig

    base = dataclasses.asdict(mixed_config())
    cfg = AngleDiffusion2DConfig(**{**base, "compute_dtype": "float32", "noise_weight": 0.0})
    small = seeded_puzzles(6, 1, True, np.random.default_rng(7))
    finals = [AngleDiffusion2D(cfg, device=device, seed=0).sample(small.to(device)).final.cpu()
              for device in ("cpu", "cuda")]
    err = (finals[1] - finals[0]).abs().max().item()
    phase(f"angle model: 6x6 sample f32, card vs CPU: max|d|={err:.3e} (tol 1e-3), final {tuple(finals[1].shape)}")
    if not (torch.isfinite(finals[1]).all() and finals[1].shape == (1, 36, 4) and err <= 1e-3):
        raise AssertionError("the angle model's sample on the card disagrees with the CPU's")

    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model, batch = AngleDiffusion2D(bf16, device="cuda", seed=0), small.to("cuda")
    patch, calls = timed_sample_calls(AngleDiffusion2D)
    torch.cuda.synchronize()
    reset_counts()
    with patch:
        final = model.sample(batch).final
    counts, routes = read_counts(), read_routes()
    n = bf16.n_layers * (bf16.steps // bf16.inference_ratio)
    if counts != {"masked_attention_fwd": n, "masked_attention_bwd_dq": 0, "masked_attention_bwd_dkv": 0} \
            or routes["masked_attention_fwd"] != {"tensor_cores": n, "cuda_cores": 0}:
        raise AssertionError(f"angle sample: launches {counts} by route {routes}, expected {n} forward launches on "
                             "the tensor cores and no backward")
    if not (torch.isfinite(final).all() and final.shape == (1, 36, 4)):
        raise AssertionError(f"angle sample bf16: final {tuple(final.shape)}, finite {bool(torch.isfinite(final).all())}")
    phase(f"angle model: 6x6 sample bf16 on the card in {calls[0]['ms']:.2f} ms (CUDA events), "
          f"{calls[0]['host_s']:.3f} s host; launches {counts}")
    return counts, routes, {"max_abs_err_f32_card_vs_cpu": err, "calls": calls}


def serve_masks():
    """(label, mask (1, 44, 44) bool on the card): a 6×6 request's graph
    under rot_ms's config (fully connected, 8 virtual nodes), as
    ``serve_norm_stats`` and ``angle_sample`` give it to the forward kernel."""
    import torch

    from diffassemble_tpu_torch.ops.attention import (build_adjacency_mask, extend_mask_with_virtual_nodes,
                                                      fully_connected_mask)

    cfg = mixed_config()
    valid = torch.ones((1, 36), dtype=torch.bool)
    adj, _ = extend_mask_with_virtual_nodes(build_adjacency_mask(fully_connected_mask(36), valid), valid,
                                            cfg.virt_nodes)
    return f"6x6 fully connected+{cfg.virt_nodes}virt, B=1", adj.cuda().contiguous()


def kernels_serve_masks(max_err: dict[str, float]) -> list[dict]:
    """The forward kernel against its plain version on a 6×6 request's mask
    (``serve_masks``) at Dh 32 and 144, bf16 on the tensor cores and f32 on
    the CUDA cores, then timed there in bf16 (``time_forward_on_mask``)."""
    import torch

    label, mask = serve_masks()
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dh in MAIN_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            _check_kernels(label, mask, dh, dtype, gen, max_err, backward=False)
    return time_forward_on_mask(mask, label, HEADS, MAIN_HEAD_DIMS, gen)


def serve_norm_stats(run_dir: Path) -> tuple[dict[str, int], dict[str, dict[str, int]], dict]:
    """The thirteenth main path: ``serve --run_dir`` on the mixed run (its
    latest checkpoint, resnet18equiv) after its OrientationNorm statistics
    were calibrated on the card over one 12×12 image's pieces and written as
    ``<run_dir>/norm_stats.npz``: ``PuzzleSolver.from_run`` serves with them
    frozen (a piece's features then do not depend on the rest of its batch),
    one 6×6 request, 120 forward launches on the tensor cores."""
    import numpy as np
    import torch

    from diffassemble_tpu_torch.cli.serve import PuzzleSolver
    from diffassemble_tpu_torch.data.patchify import patchify
    from diffassemble_tpu_torch.nn.visual import norm_layers, save_norm_stats

    solver = PuzzleSolver.from_run(run_dir, puzzle_size=6, device="cuda")
    if solver.model.norm_stats is not None:
        raise AssertionError("the run had no norm_stats.npz yet")
    img = np.random.default_rng(9).random((384, 384, 3)).astype(np.float32)
    stats = solver.model.calibrate_norm_stats([patchify(img, 12, 12, 32)])
    save_norm_stats(run_dir / "norm_stats.npz", stats)
    solver = PuzzleSolver.from_run(run_dir, puzzle_size=6, device="cuda")
    layers = norm_layers(solver.model.encoder)
    if solver.model.norm_stats is None or not all(m.frozen_mean is not None for _, m in layers):
        raise AssertionError("serve did not attach the run's norm_stats.npz")
    pieces = torch.as_tensor(patchify(img, 12, 12, 32)[:16], device="cuda")

    def batch_dependence():
        with torch.no_grad():
            alone, together = solver.model.encoder(pieces[:4]), solver.model.encoder(pieces)[:4]
        return (alone - together).abs().max().item() / together.abs().max().item()

    spread = batch_dependence()
    frozen = solver.model.norm_stats
    solver.model.norm_stats = None
    spread_batch = batch_dependence()
    solver.model.norm_stats = frozen
    reset_counts()
    start = time.perf_counter()
    out = solver.predict_array(np.random.default_rng(10).random((192, 192, 3)).astype(np.float32))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts, routes = read_counts(), read_routes()
    if counts != {"masked_attention_fwd": 120, "masked_attention_bwd_dq": 0, "masked_attention_bwd_dkv": 0} \
            or routes["masked_attention_fwd"] != {"tensor_cores": 120, "cuda_cores": 0}:
        raise AssertionError(f"serve with norm_stats: launches {counts} by route {routes}")
    if out.shape != (192, 192, 3) or not np.isfinite(out).all() or not spread <= 5e-2:
        raise AssertionError(f"serve with norm_stats: output {out.shape}, batch dependence {spread}")
    phase(f"serve --run_dir with norm_stats.npz ({len(layers)} OrientationNorm layers frozen): a 6x6 request in "
          f"{seconds:.3f} s, launches {counts}; features of 4 pieces alone vs in a batch of 16 differ by "
          f"{spread:.2e} of their largest entry (bf16 convolutions; with batch statistics {spread_batch:.2e})")
    return counts, routes, {"seconds": seconds, "batch_dependence": spread, "batch_dependence_batch_stats":
                            spread_batch}


def _family(kernel_name: str) -> str:
    name = kernel_name.lower()
    for family, keys in (("masked_attention_bwd (this port)", ("masked_attention_bwd",)),
                         ("masked_attention_fwd (this port)", ("masked_attention_fwd",)),
                         ("matmul", ("gemm", "cutlass", "xmma", "sm90", "nvjet")),
                         ("convolution", ("conv", "cudnn", "winograd", "implicit", "wgrad", "dgrad")),
                         ("reduction", ("reduce", "norm", "softmax")),
                         ("elementwise", ("elementwise", "vectorized", "unrolled"))):
        if any(k in name for k in keys):
            return family
    return "other"


def _profile(fn, label: str) -> None:
    """Run ``fn`` once (after one warm-up) under torch.profiler: wall time,
    device time by kernel family and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    families: dict[str, list[float]] = {}
    kernels = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue  # host-side operators: their device time is their kernels', counted below
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            fam = families.setdefault(_family(ev.key), [0.0, 0])
            fam[0] += dev_us / 1e3
            fam[1] += ev.count
            kernels.append((dev_us / 1e3, ev.count, ev.key))
    device_ms = sum(f[0] for f in families.values())
    if device_ms == 0:
        phase(f"profile: {label} {wall_ms:.2f} ms wall; device time not measured (the trace holds none)")
        return
    launches = sum(int(f[1]) for f in families.values())
    phase(f"profile: {label} {wall_ms:.2f} ms wall, {device_ms:.2f} ms in {launches} device kernels, "
          f"device idle share {1 - device_ms / wall_ms:.3f} (one stream: kernels do not overlap)")
    for fam, (ms, calls) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        phase(f"profile:   {fam:34s} {ms:9.3f} ms  {calls:6d} launches  {ms / device_ms:.3f} of device time")
    for ms, calls, key in sorted(kernels, reverse=True)[:12]:
        phase(f"profile:     {ms:9.3f} ms {calls:6d}x  {key[:100]}")


def profile_request() -> None:
    import numpy as np

    from diffassemble_tpu_torch.cli.serve import PuzzleSolver

    solver = PuzzleSolver(flagship_config(), seed=0, device="cuda", puzzle_size=30)
    img = np.random.default_rng(100).random((960, 960, 3)).astype(np.float32)
    _profile(lambda: solver.predict_array(img), "request")


def profile_train_step() -> None:
    """One full-width train step at batch 8 (the smoke's training recipe, on
    a batch of seeded 30×30 puzzles with one shared 10% expander)."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.train.train_state import create_train_state, make_train_step

    cfg = dataclasses.replace(flagship_config(), encoder_init="")
    rng = np.random.default_rng(7)
    batch = seeded_puzzles(30, TRAIN_BATCH, cfg.rotation, rng).to("cuda")
    adj = torch.as_tensor(seeded_puzzles(30, 1, cfg.rotation, rng, degree="10%").adj).cuda()
    batch = batch._replace(adj=batch.adj & adj)
    model = Diffusion2D(cfg, device="cuda", seed=0)
    opt = model.make_optimizer()
    holder = [create_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0))]
    step = make_train_step(model.loss, opt)

    def one_step():
        holder[0], _ = step(holder[0], batch)

    torch.cuda.reset_peak_memory_stats()
    _profile(one_step, "train step")
    phase(f"profile: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def profile_device_train_step() -> None:
    """One step of the device-resident recipe (``make_device_train_step``):
    the flagship at full width from its encoder_init, batch 8 drawn on the
    card from a corpus of 8 30×30 puzzles of the recipe's images."""
    import dataclasses

    import torch

    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.train.device_data import make_device_train_step
    from diffassemble_tpu_torch.train.train_state import create_train_state

    cfg = dataclasses.replace(flagship_config(), encoder_init=str(ENCODER_INIT))
    data = recipe_corpus()
    model = Diffusion2D(cfg, device="cuda", seed=0)
    model.init(0)
    opt = model.make_optimizer()
    holder = [create_train_state(model, opt, torch.Generator(device="cuda").manual_seed(1), ema=True)]
    step = make_device_train_step(model.loss, opt, rotation=True, ema_decay=EMA_DECAY)

    def one_step():
        holder[0], _ = step(holder[0], data, TRAIN_BATCH)

    torch.cuda.reset_peak_memory_stats()
    _profile(one_step, "device-resident train step")
    phase(f"profile: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def profile_heldout_call() -> None:
    """One held-out call of 32 puzzles with the trained weights (the accuracy
    phase's first call)."""
    import torch

    from diffassemble_tpu_torch.train.device_data import gather_batch

    _, _, model, data, rot_k, _, _ = heldout_setup(EVAL_N)
    batch = gather_batch(data, torch.arange(EVAL_N, device="cuda"), rot_k)
    torch.cuda.reset_peak_memory_stats()
    _profile(lambda: model.sample(batch).final, f"held-out call of {EVAL_N} puzzles")
    phase(f"profile: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def profile_eval3d_call() -> None:
    """One call of the 3D protocol (its first 16 objects) with the trained weights."""
    import torch

    from diffassemble_tpu_torch.train.heldout3d import model_from_asset

    model, _, p, _ = model_from_asset(ASSET_3D, "cuda")
    batch = first_batch_3d(p)
    torch.cuda.reset_peak_memory_stats()
    _profile(lambda: model.sample(batch).final, f"3D held-out call of {p['batch']} objects")
    phase(f"profile: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def profile_train3d_step() -> None:
    """One step of the 3D run at full width (its flags, seeded weights and
    encoder_init, batch 16 of 512 points and up to 8 parts: the run's first
    batch)."""
    import torch

    from diffassemble_tpu_torch.cli import train_3d
    from diffassemble_tpu_torch.models import Diffusion3D
    from diffassemble_tpu_torch.train.train_state import create_train_state, make_train_step

    args = train3d_args("")
    model = Diffusion3D(train_3d.config_from_args(args), device="cuda", seed=args.seed)
    model.init(args.seed)
    batch = loss_inputs_3d()[0].to("cuda")
    opt = model.make_optimizer()
    holder = [create_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0))]
    step = make_train_step(model.loss, opt)

    def one_step():
        holder[0], _ = step(holder[0], batch)

    torch.cuda.reset_peak_memory_stats()
    _profile(one_step, "3D train step")
    phase(f"profile: max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def kernel_line(errs: dict, rows: list[dict], sweep: list[dict], serve: tuple, train: tuple, heldout: tuple,
                recipe_: tuple, mixed_: tuple, ddp: tuple, eval3d_: tuple, train3d_: tuple, e_more: dict,
                t_more: dict, more_2d: dict) -> dict:
    """The kernels' JSON line; ``serve`` and ``train`` are (launches,
    launches by route, seconds per request or per steady step), ``heldout``,
    ``recipe_``, ``mixed_``, ``eval3d_`` and ``train3d_`` (launches, launches
    by route, the phase's result), ``ddp`` (launches, launches by route),
    ``e_more`` and ``t_more`` the results of ``eval3d_more`` and
    ``train3d_more``, ``more_2d`` the equivariant 2D family's paths by name
    (launches, launches by route, the phase's result)."""
    from diffassemble_tpu_torch import REFERENCE_PACKAGE
    from diffassemble_tpu_torch.ops import cuda_attention

    cli3d = (eval3d_[2]["cli_launches"], eval3d_[2]["cli_routes"])
    paths = {"serve": serve, "train": train, "heldout_eval": heldout, "recipe": recipe_, "mixed": mixed_,
             "ddp": ddp, "eval3d_cli": cli3d, "eval3d_heldout": eval3d_, "train3d": train3d_,
             **{f"eval3d_{name}_cli": (v[2]["cli_launches"], v[2]["cli_routes"]) for name, v in e_more.items()},
             **{f"eval3d_{name}": v for name, v in e_more.items()},
             **{f"train3d_{label}": v for label, v in t_more.items()}, **more_2d}
    out = []
    for kernel, source in KERNEL_SOURCES.items():
        # the forward kernel's figures are per denoiser step at the serving
        # shapes (B = 1); the backward kernels' per train step (B = 8)
        b = 1 if kernel == "masked_attention_fwd" else TRAIN_BATCH
        per = [r for r in rows if r["kernel"] == kernel and r["b"] == b and r["n"] == N_NODES and r["main_path"]]
        step = {key: sum(r[key] * r["launches_per_step"] for r in per)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        out.append({
            "name": kernel,
            "route": "cuda",
            "source": source,
            "sources_by_route": {"tensor_cores": source, "cuda_cores": CUDA_CORE_SOURCES[kernel]},
            "replaces": f"{REFERENCE_PACKAGE}/{cuda_attention.REPLACES[kernel]}",
            "launches": sum(path[0][kernel] for path in paths.values()),
            "launches_by_path": {name: path[0][kernel] for name, path in paths.items()},
            "launches_by_route": {name: path[1][kernel] for name, path in paths.items()},
            "max_abs_err": errs[kernel],
            "ms": step["ms"],
            "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"],
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in per) else "bytes",
            "library_ms": step["library_ms"],
            **({} if b == 1 else {"library_computes": "dQ, dK and dV in one SDPA backward, the same call in both "
                                                      "backward rows: set it against the sum of their ms"}),
            "times_are_for": (f"one {'denoiser step' if b == 1 else 'train step'}: 3 launches at Dh=32 and 1 at "
                              f"Dh=144, B={b}, H={HEADS}, N={N_NODES}, bf16, route {per[0]['route']}"),
            "per_shape": [r for r in rows if r["kernel"] == kernel],
        })
    out[0]["block_rows_sweep"] = sweep
    out[0]["seconds_per_request"] = serve[2]
    out[1]["seconds_per_train_step"] = train[2]
    out[0]["heldout_eval"] = heldout[2]
    out[1]["recipe"] = recipe_[2]
    out[1]["mixed"] = {k: v for k, v in mixed_[2].items() if k not in ("corpus", "run_dir")}
    out[0]["eval3d"] = {k: v for k, v in eval3d_[2].items() if k not in ("cli_launches", "cli_routes")}
    out[1]["train3d"] = train3d_[2]
    out[0]["eval3d_more"] = {name: {k: v for k, v in r[2].items() if k not in ("cli_launches", "cli_routes", "calls")}
                             | {"rows": [{k: v for k, v in row.items() if k != "calls"} for row in r[2]["rows"]]}
                             for name, r in e_more.items()}
    out[1]["train3d_more"] = {label: r[2] for label, r in t_more.items()}
    out[0]["equivariant_2d"] = {name: r[2] for name, r in more_2d.items()}
    return {"kernels": out}


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--profile", nargs="?", const="serve",
                    choices=["serve", "train", "eval", "train-device", "eval3d", "train3d"],
                    help="instead of the smoke run, profile one serving request (default), one train step, "
                         "one held-out call of 32 puzzles with the trained weights, one step of the "
                         "device-resident recipe, one 3D held-out call of 16 objects, or one 3D train step")
    args = ap.parse_args()

    smi, name, count = environment()
    build()
    if args.profile:
        {"serve": profile_request, "train": profile_train_step, "eval": profile_heldout_call,
         "train-device": profile_device_train_step, "eval3d": profile_eval3d_call,
         "train3d": profile_train3d_step}[args.profile]()
        print(smi, flush=True)
        return
    errs = kernels_vs_plain()
    rows, sweep = timing()
    serve = serving()
    gradient_parity()
    card_vs_cpu_training()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as tmp:
        train = training(Path(tmp))
    heldout = accuracy()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recipe_") as tmp:
        rec = recipe(Path(tmp))
        device_step_vs_train_state_step()
        mix = mixed(Path(tmp))
        rows_2d = mixed_kernels(mix[2]["corpus"], errs)
        rows_2d += kernels_serve_masks(errs)
        served = serve_norm_stats(mix[2]["run_dir"])
        rot_ms = eval_rot_ms(Path(tmp))
    ddp = ddp_world_of_one()
    rows_2d += kernels_discrete_masks(errs)
    discrete = eval_discrete()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_discrete_") as tmp:
        discrete_train = train_discrete(Path(tmp))
    angle = angle_sample()
    labels = {r["mask"]: None for r in rows_2d}  # mixed, 6×6 request, discrete, in order
    mixed_mask, serve_mask, discrete_mask = labels
    rows += attach_launches_2d(rows_2d, {
        mixed_mask: {"mixed_steps": mix[2]["steps"], "mixed_evaluations": mix[2]["evals"],
                     "rot_ms_heldout": rot_ms[2]["calls"]},
        serve_mask: {"serve_norm_stats": [{"routes": served[1]}], "angle_sample": angle[2]["calls"]},
        discrete_mask: {"discrete_heldout": discrete[2]["calls"], "discrete_train": discrete_train[2]["steps"]}})
    more_2d = {"rot_ms_heldout": rot_ms, "discrete_heldout": discrete, "discrete_train": discrete_train,
               "serve_norm_stats": served, "angle_sample": angle}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3d_") as tmp:
        *e3d, rows3d = eval3d(Path(tmp), errs)
        *t3d, rows_t3d = train3d(Path(tmp), errs)
        rows_w = kernels_3d_widths(errs)
        e_more = eval3d_more(Path(tmp))
        t_more = train3d_more(Path(tmp))
    rows += rows3d + rows_t3d + attach_launches_3d(rows_w, e_more, t_more)
    paths = {"serve": serve[0], "train": train[0], "held-out eval": heldout[0], "recipe": rec[0],
             "mixed": mix[0], "ddp": ddp[0], "3D run_3d --evaluate": e3d[2]["cli_launches"],
             "3D held-out": e3d[0], "3D train": t3d[0],
             **{f"3D {name} run_3d --evaluate": v[2]["cli_launches"] for name, v in e_more.items()},
             **{f"3D {name} held-out": v[0] for name, v in e_more.items()},
             **{f"3D train {label}": v[0] for label, v in t_more.items()},
             **{name: v[0] for name, v in more_2d.items()}}
    # these launch the forward kernel alone
    sampling_only = {"serve", "held-out eval", "3D run_3d --evaluate", "3D held-out", "rot_ms_heldout",
                     "discrete_heldout", "serve_norm_stats", "angle_sample",
                     *(f"3D {name} {what}" for name in e_more for what in ("run_3d --evaluate", "held-out"))}
    idle = {path: counts for path, counts in paths.items()
            if any(v == 0 for k, v in counts.items() if path not in sampling_only or k == "masked_attention_fwd")}
    if idle:
        raise AssertionError(f"a kernel of a main path was not launched: {idle}")
    line = kernel_line(errs, rows, sweep, serve, train, heldout, rec, mix, ddp, tuple(e3d), tuple(t3d), e_more,
                       t_more, more_2d)
    phase("done")
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
