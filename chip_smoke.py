#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diffassemble_tpu_torch``) on one GPU.

    python3 chip_smoke.py                  # the smoke run
    python3 chip_smoke.py --profile        # one serving request under torch.profiler
    python3 chip_smoke.py --profile train  # one full-width train step under torch.profiler
    python3 chip_smoke.py --profile eval   # one held-out call of 32 puzzles, trained weights
    python3 chip_smoke.py --profile train-device  # one step of the device-resident recipe
    python3 chip_smoke.py --profile eval3d  # one 3D held-out call of 16 objects, trained weights
    python3 chip_smoke.py --profile train3d  # one full-width 3D train step
    python3 chip_smoke.py --only tensor_parallel  # the build and phase 22 alone
    python3 chip_smoke.py --only f32_rounding  # the f32 tensor-core kernels' error against emulations

Phases, each ending in a line with the elapsed seconds:

1. environment: the card's name and power limit (nvidia-smi), device count;
2. build: the masked-attention kernels from ``csrc/`` with nvcc (one nvcc
   per source, in parallel; -Xptxas -v), failing if a tensor-core kernel
   (bf16, or the f32 backward pair) or a small-graph kernel (the forward,
   the fused backward) spills registers;
3. the forward kernel against its plain PyTorch version on the card:
   the 10% expander + 8 virtual nodes at the main paths' batches (B = 1 for a
   request, B = 8 for a train step), the same with padded nodes and empty
   rows, fully connected, N = 200, and the held-out evaluation's committed
   expander + 8 virtual nodes at B = 32, at head widths 32 and 144, in bf16 and
   f32; then the two backward kernels (dQ, and dK/dV) against theirs over the
   same masks, with exact zeros on empty query rows and unattended keys. In
   bf16 at Dh 32 and 144 all three run on the tensor-core route, and in f32
   too (3xTF32, ``csrc/masked_attention_fwd_tc_f32.cu`` and
   ``csrc/masked_attention_bwd_tc_f32.cu``); each line names its
   route, and a kernel on another route than its type and width call for
   fails. Inputs 2 bytes (bf16) or 4 bytes (f32) off a 16-byte boundary run
   all three on the CUDA-core route on the B = 1
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
   kernels at Dh 20, 104 and 264; in f32 at B = 8 (``time_on_masks``) the
   tensor-core dQ and dK/dV beside the CUDA-core pair on the same inputs,
   their plain versions, one f32 SDPA backward and their bound, and the
   tensor-core forward beside the CUDA-core forward on the same inputs and
   the f32 SDPA forward, the forward so at B = 32 too (every f32 bound at
   the TF32 rate);
5. serving, the first main path: the flagship 30×30 rotation config from
   ``weights/diffusion2d_rot30/config.json`` (JSON only) with seeded weights;
   one denoiser call with the kernel against the same call with plain
   attention; a 6×6 sample on the card against the CPU; then
   ``PuzzleSolver.predict_array`` on 3 seeded 960×960 images, with exactly
   120 forward launches (4 layers × 30 steps), all on the tensor cores, and
   no backward launch each;
6. training: a full-width f32 step's gradients with the kernels against the
   same step with plain attention (every query/key/value weight gets a
   finite, nonzero gradient; the forward, dQ and dK/dV on the tensor cores,
   3xTF32); a 6×6 f32 train step on the card against the CPU (the
   same routes at N = 44); then the second main path, ``run_2d`` of the rotation CLI with the
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
   the same puzzles over a fully connected graph and in calls of 8. Then the
   same weights in f32 (the model's default precision) over the same
   puzzles and the expander the gate chose, in two calls of 32: each 120
   forward launches, all ``masked_attention_fwd_tc_f32``, and a piece_acc
   within 0.01 of the card's bf16 one there, each call timed by CUDA events
   and the host clock, with its peak memory;
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
   152 with padding rows and unattended keys; bf16 and f32 on the tensor
   cores) and timed there beside their bound and
   ``scaled_dot_product_attention``, in bf16 and f32; then the forward kernel against its
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
   nodes, B = 32) and timed there, in bf16 and f32; the trained ``diffusion2d_discrete_rot6``
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
   parts with empty rows) at Dh 32 and 264 in bf16 and f32 (the
   small-graph forward, ``csrc/masked_attention_fwd_small.cu``, at all but
   bf16 Dh 32), timed beside its bound over the attended pairs and SDPA,
   the small-graph row beside the CUDA-core forward it replaced on the same
   inputs; then the asset written as a
   port run and evaluated by ``cli/train_3d.py``'s ``run_3d --evaluate``,
   and the protocol through ``train/heldout3d.py``. Each call has exactly
   120 forward launches, 90 on the tensor cores (Dh 32) and 30 on the
   small-graph route (Dh 264, N = 8), none on the CUDA cores, and no
   backward launch. It fails unless
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
   512 points and 2–8 parts). First the backward (after the forward) against
   its plain version on the masks of the run's first batch (B = 16, N =
   8, padding parts with empty rows and unattended keys) at Dh 32 (bf16: dQ
   and dK/dV on the tensor cores; f32: the fused small-graph kernel) and 264
   (fused) in bf16 and f32, with exact zeros, then timed beside its bound
   over the attended pairs and one SDPA backward, each fused row beside the
   CUDA-core dQ + dK/dV pair it replaced on the same inputs;
   the trained weights' training loss on that batch with numpy draws, in
   bf16 and f32, against the JAX package's CPU values (``JAX_CPU_LOSS_3D``,
   ``TOL_LOSS_3D``); one f32 step's gradients with the kernels against plain
   attention. Then ``run_3d`` without ``--evaluate`` on a corpus cut to 48
   training and 16 held-out objects: a sanity evaluation, 4 steps with an
   evaluation and a checkpoint at step 4, a resume to step 6. Every step
   has exactly 8 forward launches (the denoiser runs twice, its diffusion
   pass and the aux-pose pass), 6 on the tensor cores and 2 on the
   small-graph route, 6 dQ and 6 dK/dV launches on the tensor cores with one Δ each,
   and 2 fused backward launches (the small-graph route: N = 8, Dh 264)
   with no Δ outside them; finite losses and nonzero gradients in the
   encoder, the pairwise head and the denoiser; every evaluation call 120
   forward launches and no backward. It prints s/step by host clock and
   CUDA events and the peak memory;
14. the kernels at every head width of the 3D family (32 and the widths of
   phase 3) against their plain versions in bf16 and f32, with exact zeros
   and routes, on the 3D protocols' own masks: N = 8 (``diffusion3d_easy``'s
   first call) and N = 20 (``diffusion3d_vndgcnn``'s, mostly padding rows):
   the forward and the backward on their route, the small-graph forward
   (``csrc/masked_attention_fwd_small.cu``) and the fused backward (``csrc/
   masked_attention_bwd_small.cu``) at every width but bf16 Dh 32, and on
   bf16 inputs 2 bytes off a 16-byte boundary at Dh 32 and 144; on the N
   = 20 mask at Dh 271 ``MaskedAttention``'s backward is one fused launch
   with no Δ outside it; then timed at N = 20 at Dh 24, 32, 40, 104, 136 and
   271 and at N = 8 at Dh 136 beside their bound over the attended pairs and
   SDPA, each small-graph forward row beside the CUDA-core forward and each
   fused row beside the CUDA-core pair it replaced;
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
   attention. Every step has the forward once a layer per denoiser pass, one
   layer on the small-graph route, the backward of that layer fused and the
   others' dQ and dK/dV on the tensor cores, finite losses and nonzero
   gradients;
17. the light encoders and the GCN backbone: ``run_2d`` of the rotation CLI
   at the flagship's flags (30×30 over the 10% expander, exophormer, bf16,
   batch 8) from seeded weights with ``--backbone convnet`` and ``tiny`` (2
   steps, a checkpoint, a resume to 3; each step 4 + 4 + 4 tensor-core
   launches) and with ``--architecture gcn`` (2 steps: no attention launch
   at all, the sanity evaluation's included); each first holds its seeded
   f32 loss on the card to the CPU's (``card_vs_cpu_loss_2d``); s/step by
   host clock and CUDA events and peak memory beside phase 6's;
18. ``visual_pretrained``: a features npz in the layout of a converted timm
   file (the encoder subtree of ``weights/efficientnet_b0_pose30hf.npz``);
   after ``init`` the encoder equals the file, and a patch's bf16 features
   agree within 1/64 of the largest in batches of 4 and 16 (the BatchNorms
   folded affine); its seeded f32 loss on the card held to the CPU's; then
   2 steps through ``train_2d_rot --visual_pretrained true``;
19. ``cli/train_2d_missing.py`` (``--missing 20``) with the flagship's
   flags: its seeded f32 loss on 6×6 puzzles with 28 valid pieces of 36
   held on the card to the CPU's, then 2 steps after its sanity
   evaluation, every puzzle with 720 valid pieces of 900;
20. ``cli/evaluate.py`` on the trained flagship and ``diffusion2d_rot_ms``
   written as runs of the port, in four calls of one batch of 4, each 120
   forward launches on the tensor cores and a sample bit-equal to the
   asset's weights sampled apart from the run: the flagship on
   ``get_dataset``'s default images and on its recipe's (piece_acc at least
   EVAL_CLI_MIN_ACC); rot_ms at 6×6 with its OrientationNorm statistics
   calibrated over 2 training batches into ``norm_stats.npz`` (equal to a
   calibration apart) and its 120 step images (``.npy`` where PIL is
   missing) counted, then at its protocol's sizes (piece_acc at least
   EVAL_CLI_MIN_ACC, and within PIECE_ACC_TOL of the CPU's in f32);
21. ``run_3d --evaluate --export_meshes`` on the trained
   ``diffusion3d_easy`` cut to 4 objects: 120 ``.ply`` and 4 ``_traj.npz``,
   each trajectory's last step bit-equal to a ``sample`` without one, 90
   forward launches a call of 120 on the tensor cores and 30 on the
   small-graph route; then
   one ``Trainer`` step of the 3D model with the easy run's flags under DDP
   in a world of one over NCCL, bit-equal to the plain step (8 forward, 6 on
   the tensor cores and 2 on the small-graph route, 6 + 6 tensor-core dQ and
   dK/dV and 2 fused launches a step). No 3D path launches a CUDA-core
   kernel;
22. tensor parallelism on one card (``tensor_parallel``): the three kernels
   at a tp rank's shapes (H = 4, N = 908, B = 1 and 8, Dh 32 and 144)
   against their plain versions in bf16 and f32, then timed
   beside their bound, plain versions and SDPA (in f32 too, the backward
   pair beside the CUDA-core pair), and the forward at phase
   20's and 21a's shapes (B = 4 at N = 908; the 3D export's N = 8); the
   kernels at the dp 2 × tp 2 3D rank step's shapes (H = 4, each dp place's
   8 objects, N = 8, Dh 32 and 264: the fused kernel at all but bf16 Dh 32)
   against their plain versions in bf16 and f32; then ranks spawned as
   processes on the one card in a gloo group over CUDA tensors (NCCL refuses
   two ranks on one device), each held to the same work in this process:
   at tp = 2 and the flagship's full width (each rank 4 of the 8 heads), a
   Trainer step at batch 8 over the 10% expander in f32 (``GRAD_TOL``, 4 +
   4 + 4 launches a rank, all on the tensor cores, 3xTF32) and in bf16 (its
   loss, gradient
   norms and gradients within ``TP_BF16_TOL``, 4 + 4 + 4 on the tensor
   cores), the ranks' whole parameters equal, each update equal to the
   single-process optimizer's on the rank's gradients, the tp
   collectives' share of a step timed; a 30-step request and one held-out
   call of 32 puzzles with the trained EMA (120 forward launches a rank on
   the tensor cores; positions within ``TP_REQUEST_TOL``, piece_acc within
   ``TP_PIECE_ACC_TOL`` of one process's); then dp = 2 × tp = 2 in four
   processes: one f32 step of the flagship at batch 8 and one of the 3D
   model with the easy run's flags at batch 16 against one process on the
   whole batch (``GRAD_TOL``, the 3D step's gradients within
   ``DPTP_3D_GRAD_REL``; each update equal to the single-process
   optimizer's on the rank's gradients; the 3D step's forward all on the
   small-graph route and its backward all fused),
   with each rank's peak memory. A rank that fails fails the phase.

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
H100_TF32_FLOPS = 495e12  # dense TF32 tensor-core peak: the card's f32 products, whichever kernel does them
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
# the wrappers of cuda_attention, each counting its launches (read_counts, read_routes)
FUSED = "masked_attention_bwd_small"
WRAPPERS = ("masked_attention_fwd", "masked_attention_bwd_dq", "masked_attention_bwd_dkv", FUSED)
# the forward's kernel on the small-graph route (N <= 32 off the tensor cores: every 3D path's wide
# layer, every 3D layer in f32); it launches through the forward's wrapper, counted on that route
FWD_SMALL = "masked_attention_fwd_small"
# read_routes's entry of launches by C function, beside each wrapper's launches by route
FUNCTIONS = "by_function"
# the kernels line's entries: each one's C functions (cuda_attention.c_function) by route, the first
# one's source naming the entry: the forward, dQ and dK/dV on the tensor cores in bf16 (Dh 32 and 144)
# and on the CUDA cores, the fused small-graph backward, the small-graph forward, and dQ, dK/dV and the
# forward on the tensor cores in float32 (3xTF32, N > 32 at Dh 32 and 144)
LINE_ENTRIES = {
    **{name: {"tensor_cores": f"{name}_tc", "cuda_cores": name}
       for name in ("masked_attention_fwd", "masked_attention_bwd_dq", "masked_attention_bwd_dkv")},
    FUSED: {"small_graph": FUSED},
    FWD_SMALL: {"small_graph": FWD_SMALL},
    **{f"{name}_tc_f32": {"tensor_cores": f"{name}_tc_f32"}
       for name in ("masked_attention_bwd_dq", "masked_attention_bwd_dkv", "masked_attention_fwd")},
}
F32_STEP_ROUTES = "all three on the tensor cores (3xTF32)"
# the kernels line's max_abs_err, by C function
ERR_KEYS = tuple(fn for functions in LINE_ENTRIES.values() for fn in functions.values())
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
# phases 17-19: the flagship's training flags with the light encoders, the GCN backbone, pretrained
# features and missing pieces: 2 steps, and for the light encoders a resume to step 3
LIGHT_STEPS, LIGHT_RESUME_TO = 2, 3
MISSING_PERC = 20  # cli/train_2d_missing.py's default
# phase 20: the least piece_acc of cli/evaluate.py's batch of 4 on puzzles made as the checkpoint's
# training made them (the flagship on its recipe's images, rot_ms at its protocol's sizes)
EVAL_CLI_MIN_ACC = 0.95

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
             pairs: int | None = None, edges: tuple[int, int] | None = None) -> tuple[float, str]:
    """Least time on an H100 for one launch: the larger of its operations over
    the card's peak rate for the type (bf16 and f32 products on the tensor
    cores, f32 at the TF32 rate, each product counted once whatever route
    does it) and the bytes it must move (each input read once, each output
    written once) over the memory rate.

    forward: S and O·V, 4·H·Dh per attended (query, key) pair; reads q, k, v
    and the mask, writes O, L.
    dQ: S, dP and dQ, 6·H·Dh a pair; reads q, k, v, dO, L, Δ and the mask, writes dQ.
    dK/dV: S, dP, dV and dK, 8·H·Dh a pair; reads q, k, v, dO, L, Δ and the mask,
    writes dK and dV.
    the fused small-graph backward: S, dP, dQ, dK and dV, 10·H·Dh a pair; reads
    q, dO and O on the query rows with an edge, k and v on the attended keys,
    and L and the mask whole; writes dQ, dK and dV whole.
    the small-graph forward: as the forward, 4·H·Dh a pair; reads q on the
    query rows with an edge, k and v on the attended keys, and the mask;
    writes O and L whole.
    ``pairs`` is the mask's attended pairs (default: all B·N², fully
    connected); ``edges`` its (query rows with an edge, attended keys), each
    counted over (B, N) (default: all B·N)."""
    tensor = b * n * h * dh * elem_bytes  # one (B, N, H, Dh) tensor
    row = 4.0 * b * h * n  # one (B, H, N) f32 tensor
    mask = b * n * n
    pairs = mask if pairs is None else pairs
    queries, keys = (b * n, b * n) if edges is None else edges
    per_row = h * dh * elem_bytes  # one node's row of a (B, N, H, Dh) tensor
    flops, nbytes = {
        "masked_attention_fwd": (4, 4 * tensor + row + mask),
        "masked_attention_bwd_dq": (6, 5 * tensor + 2 * row + mask),
        "masked_attention_bwd_dkv": (8, 6 * tensor + 2 * row + mask),
        FUSED: (10, (3 * queries + 2 * keys) * per_row + 3 * tensor + row + mask),
        FWD_SMALL: (4, (queries + 2 * keys) * per_row + tensor + row + mask),
    }[kernel]
    rate = H100_BF16_FLOPS if elem_bytes == 2 else H100_TF32_FLOPS
    t_ops = flops * h * pairs * dh / rate
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
    try:  # the drawings are PNGs with PIL, .npy pixels without
        import PIL

        pil = f"PIL {PIL.__version__}"
    except ImportError:
        pil = "no PIL"
    phase(f"environment: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"device {name} | count {count} | {pil}")
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
        if ("_tc" in source or "_small." in source) and "spill" in line \
                and not line.strip().endswith("0 bytes spill stores, 0 bytes spill loads"):
            spills.append(line.strip())
    phase(f"build: {', '.join(p.name for p in lib.paths.values())} in {lib.build_seconds:.2f} s")
    if spills:
        raise AssertionError(f"a tensor-core or a small-graph kernel spills registers: {spills}")


def reset_counts() -> None:
    from diffassemble_tpu_torch.ops import cuda_attention

    cuda_attention.reset_launch_counts()


def read_counts() -> dict[str, int]:
    from diffassemble_tpu_torch.ops import cuda_attention

    return {kern.__name__: kern.launches for kern in cuda_attention.KERNELS}


def read_routes() -> dict[str, dict[str, int]]:
    """Each wrapper's launches by route, and under ``FUNCTIONS`` the launches
    by C function of all of them (``cuda_attention.c_function``)."""
    from diffassemble_tpu_torch.ops import cuda_attention

    routes = {kern.__name__: dict(kern.launches_by_route) for kern in cuda_attention.KERNELS}
    routes[FUNCTIONS] = {fn: n for kern in cuda_attention.KERNELS for fn, n in kern.launches_by_function.items()}
    return routes


def routes_since(before: dict[str, dict[str, int]]) -> dict[str, dict[str, int]]:
    return {k: {r: n - before[k].get(r, 0) for r, n in now.items()} for k, now in read_routes().items()}


def by_route(routes: dict[str, dict[str, int]]) -> dict[str, dict[str, int]]:
    """``routes`` without its launches by C function: as the gates' expectations are keyed."""
    return {k: v for k, v in routes.items() if k != FUNCTIONS}


def launches_of(fwd: int = 0, dq: int = 0, dkv: int = 0, fused: int = 0) -> dict[str, int]:
    """A gate's launches of each kernel, keyed as ``read_counts``."""
    return dict(zip(WRAPPERS, (fwd, dq, dkv, fused)))


def on_routes(tensor_cores: int = 0, cuda_cores: int = 0, small_graph: int = 0) -> dict[str, int]:
    """A gate's launches of one kernel by route, keyed as ``read_routes``."""
    return {"tensor_cores": tensor_cores, "cuda_cores": cuda_cores, "small_graph": small_graph}


def step_routes_3d(passes: int, layers: int, dtype: str = "bfloat16") -> dict[str, dict[str, int]]:
    """A 3D train step's launches by kernel and route: each denoiser pass
    launches the forward once a layer, on the small-graph route (N <= 32) at
    the last layer's width and (bf16) on the tensor cores at the others' Dh
    32, and each layer's backward once: on the tensor cores where its
    forward is (dQ and dK/dV), else on the small-graph route (the fused
    kernel). No 3D layer launches a CUDA-core kernel."""
    tc = passes * (layers - 1) if dtype == "bfloat16" else 0
    sg = passes * layers - tc
    return {"masked_attention_fwd": on_routes(tensor_cores=tc, small_graph=sg),
            "masked_attention_bwd_dq": on_routes(tensor_cores=tc),
            "masked_attention_bwd_dkv": on_routes(tensor_cores=tc), FUSED: on_routes(small_graph=sg)}


def f32_step_routes_2d(launches: int = 4) -> dict[str, dict[str, int]]:
    """A float32 2D step's launches by kernel and route (N > 32 nodes at the
    main widths): each kernel ``launches`` times, all on the tensor cores
    (3xTF32), no fused launch."""
    return {"masked_attention_fwd": on_routes(tensor_cores=launches),
            "masked_attention_bwd_dq": on_routes(tensor_cores=launches),
            "masked_attention_bwd_dkv": on_routes(tensor_cores=launches), FUSED: on_routes()}


def counts_of(routes: dict[str, dict[str, int]]) -> dict[str, int]:
    """Launches by kernel from launches by kernel and route."""
    return {k: sum(n.values()) for k, n in by_route(routes).items()}


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
                   misaligned: bool = False, backward: bool = True, heads: int = HEADS) -> None:
    """The forward kernel and the backward of its route (the forward alone
    without ``backward``) against their plain versions on one mask, width,
    head count and type, on the route these call for: the tensor cores for
    bf16 at the main paths' widths (forward, dQ and dK/dV), and in f32 there
    on more than ``SMALL_GRAPH_N`` nodes (3xTF32); else (and for
    ``misaligned`` inputs, one element
    past a 16-byte boundary) the small-graph route where N is at most
    ``SMALL_GRAPH_N`` (the small-graph forward, and the fused backward: dQ, dK
    and dV in one launch), the CUDA cores above it (the forward, dQ and
    dK/dV); raises on a disagreement or another route. Updates ``max_err``
    per C function launched (``ERR_KEYS``)."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    b, n, _ = mask.shape
    empty = ~mask.any(-1)  # (B, N) query rows with no edges
    unattended = ~mask.any(-2)  # (B, N) keys no query attends
    q, k, v, dout = (torch.randn((b, n, heads, dh), generator=gen, device="cuda").to(dtype) for _ in range(4))
    if misaligned:
        q, k, v, dout = (_misaligned(t) for t in (q, k, v, dout))
        label = f"{label}, misaligned"
    aligned_main = dh in MAIN_HEAD_DIMS and not misaligned
    off_tc = "small_graph" if n <= ca.SMALL_GRAPH_N else "cuda_cores"
    # in f32 on more than SMALL_GRAPH_N nodes the tensor cores too (3xTF32)
    want = "tensor_cores" if aligned_main and (dtype == torch.bfloat16 or off_tc == "cuda_cores") else off_tc
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
    nonempty = ~empty[:, None, :].expand(b, heads, n)
    lse_err = (lse - lse_p).abs()[nonempty]
    ok = (
        bool(torch.isfinite(of).all()) and bool(torch.isfinite(lse).all())
        and bool((err <= tol).all())
        and bool((lse_err <= 1e-5 * (1 + lse_p.abs()[nonempty])).all())
        and bool((of[empty] == 0).all())
        and torch.equal(lse[~nonempty], lse_p[~nonempty])
    )
    fwd_key = ca.c_function("masked_attention_fwd", fwd_route, dtype)
    max_err[fwd_key] = max(max_err[fwd_key], err.max().item())
    phase(f"fwd vs plain: {label:34s} B={b} N={n} H={heads} Dh={dh:3d} {str(dtype)[6:]:8s} {fwd_route:12s} "
          f"max|dO|={err.max().item():.3e} worst err/tol {(err / tol).max().item():.3f} "
          f"max|dL|={lse_err.max().item():.3e} "
          f"empty rows={int(empty.sum())} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"forward kernel disagrees with its plain version: {label} Dh={dh} {dtype}")
    if not backward:
        return

    # the backward, from this forward's O and L, on the forward's route: on the small-graph route the
    # fused kernel (dQ, dK and dV in one launch, Δ in it), else the dQ and dK/dV kernels
    delta = ca.attention_delta(dout, o)
    args = (q, k, v, mask, dout, lse, delta)
    routes = {ca.route(name, *args) for name in ca.BACKWARD_PAIR}
    if routes != {want}:
        raise AssertionError(f"backward routes {routes} at Dh={dh} {dtype}, expected {want}")
    if want == "small_graph":
        dq, dk, dv = ca.masked_attention_bwd_small(q, k, v, mask, dout, o, lse)
        torch.cuda.synchronize()
        dq_p, dk_p, dv_p = ca.masked_attention_bwd_small_plain(q, k, v, mask, dout, o, lse)
        owner = dict.fromkeys(("dQ", "dK", "dV"), FUSED)
    else:
        dq = ca.masked_attention_bwd_dq(*args)
        dk, dv = ca.masked_attention_bwd_dkv(*args)
        torch.cuda.synchronize()
        dq_p = ca.masked_attention_bwd_dq_plain(*args)
        dk_p, dv_p = ca.masked_attention_bwd_dkv_plain(*args)
        owner = {key: ca.c_function(kernel, want, dtype) for key, kernel in
                 (("dQ", "masked_attention_bwd_dq"), ("dK", "masked_attention_bwd_dkv"),
                  ("dV", "masked_attention_bwd_dkv"))}
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
    for key, kernel in owner.items():
        max_err[kernel] = max(max_err[kernel], errs[key])
    phase(f"bwd vs plain: {label:34s} B={b} N={n} H={heads} Dh={dh:3d} {str(dtype)[6:]:8s} {want:12s} "
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
    max_err = dict.fromkeys(ERR_KEYS, 0.0)
    masks = _masks(torch, np)
    for label, mask in masks:
        for dh in MAIN_HEAD_DIMS:
            for dtype in (torch.bfloat16, torch.float32):
                _check_kernels(label, mask, dh, dtype, gen, max_err)
    for dh in MAIN_HEAD_DIMS:  # the CUDA-core route in both types at the main paths' widths
        for dtype in (torch.bfloat16, torch.float32):
            _check_kernels(masks[0][0], masks[0][1], dh, dtype, gen, max_err, misaligned=True)
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
    """A contiguous copy of ``x`` starting one element (2 bytes in bf16, 4 in
    f32) past a 16-byte boundary: the kernels take the CUDA-core route for it."""
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
    main paths, and in f32 the three tensor-core kernels (3xTF32,
    ``time_on_masks``), each beside the CUDA-core kernel on the same inputs;
    in f32 at B = 32 (a held-out call's) the tensor-core forward beside the
    CUDA-core forward (``time_forward_on_mask``). Rows off the main paths
    have ``main_path`` false. Returns the rows and the block-size sweep."""
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
                here.append({"kernel": kernel, "function": ca.c_function(kernel, route, q.dtype), "b": b,
                             "n": N_NODES, "h": HEADS, "dh": dh, "dtype": "bfloat16", "route": route,
                             "main_path": main, "launches_per_step": count, "ms": ms, "plain_ms": plain_ms,
                             "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by})
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
                    here.append({**ref, "route": "cuda_cores", "function": kernel, "main_path": False,
                                 "launches_per_step": 0, "ms": cc[kernel]})
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
    # float32 at the training shapes (the three kernels on the tensor cores, 3xTF32) and a held-out call's
    mask = torch.ones((TRAIN_BATCH, N_NODES, N_NODES), dtype=torch.bool, device="cuda")
    f32 = time_on_masks(mask, f"fully connected, B={TRAIN_BATCH}", MAIN_HEAD_DIMS, gen, dtype="float32")
    for r in f32:
        r["launches_per_step"] = dict(STEP_LAUNCHES)[r["dh"]]
    mask = torch.ones((EVAL_N, N_NODES, N_NODES), dtype=torch.bool, device="cuda")
    f32_eval = time_forward_on_mask(mask, f"fully connected, B={EVAL_N} (held-out call)", HEADS, MAIN_HEAD_DIMS,
                                    gen, dtype="float32")
    for r in f32_eval:
        r["launches_per_step"] = dict(STEP_LAUNCHES)[r["dh"]]
    for r in f32 + f32_eval:
        if r["route"] != "tensor_cores":
            raise AssertionError(f"f32 {r['kernel']} at B={r['b']} Dh={r['dh']} takes the {r['route']} route")
    return rows + f32 + f32_eval, sweep


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


def seeded_puzzles(n: int, count: int, rotation: bool, rng, degree=None, missing_perc: int = 0):
    """``count`` n×n puzzles of seeded random images, collated; with a
    ``degree`` the piece graph is that expander, else fully connected. With
    ``missing_perc`` each puzzle loses ⌈n²·missing_perc/100⌉ random pieces,
    as ``PuzzleDataset`` drops them, and is padded back to n² nodes."""
    import numpy as np

    from diffassemble_tpu_torch.data import collate_puzzles, expander_mask, make_puzzle

    samples = []
    for _ in range(count):
        s = make_puzzle(rng.random((n * 32, n * 32, 3)).astype(np.float32), n, n, 32, rotation=rotation, rng=rng)
        if missing_perc:
            keep = np.sort(rng.permutation(n * n)[: n * n - math.ceil(n * n * missing_perc / 100)])
            s.update({k: s[k][keep] for k in ("patches", "x0", "grid", "rot_k")})
        if degree is not None:
            s["adj"] = expander_mask(len(s["x0"]), degree, rng)
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
    before_routes = read_routes()
    final_gpu = Diffusion2D(small_cfg, device="cuda", seed=0).sample(small.to("cuda")).final.cpu()
    launched = f32_forward_launches(before_routes, cfg.n_layers * (cfg.steps // cfg.inference_ratio), "6x6 sample f32")
    err = (final_gpu - final_cpu).abs().max().item()
    phase(f"6x6 sample f32, card vs CPU: max|d|={err:.3e} (tol 1e-3); {launched}")
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
        if launched != launches_of(fwd=per_request):
            raise AssertionError(f"expected {per_request} forward launches and no backward launch per request")
        if fwd_routes != on_routes(tensor_cores=per_request):
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


def f32_forward_launches(before: dict[str, dict[str, int]], n: int, label: str) -> str:
    """Since ``before`` (``read_routes``): ``n`` forward launches, all of them
    ``masked_attention_fwd_tc_f32`` on the tensor cores, and no other kernel
    launched; raises otherwise. Returns a line that says so."""
    routes = routes_since(before)
    by_function = {fn: c for fn, c in routes[FUNCTIONS].items() if c}
    if routes["masked_attention_fwd"] != on_routes(tensor_cores=n) or by_function != {"masked_attention_fwd_tc_f32": n}:
        raise AssertionError(f"{label}: launches by route {routes}, expected {n} launches of masked_attention_fwd_tc_f32")
    return f"{n} forward launches, all masked_attention_fwd_tc_f32 on the tensor cores"


def gradient_parity() -> None:
    """A full-width f32 step's gradients with the kernels against the same
    step with plain attention, on two 30×30 puzzles with the flagship's 10%
    expander. Tolerance: 1e-3 of each parameter's largest gradient entry plus
    1e-6 of the model's (sums in another order through four layers and the
    encoder; gradients that are 0 in exact arithmetic are rounding noise).
    The kernels' step launches the forward, dQ and dK/dV on the tensor cores
    (3xTF32), once a layer each."""
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
            before, before_routes = read_counts(), read_routes()
            loss, _ = model.loss(batch, gen)
            loss.backward()
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in read_counts().items()}
            routes = routes_since(before_routes)
        if launched != launches_of(*(3 * [0 if swap else cfg.n_layers])) or \
                (not swap and by_route(routes) != f32_step_routes_2d(cfg.n_layers)):
            raise AssertionError(f"unexpected launches {launched}, by route {routes} (plain attention: {swap})")
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
          f"{len(plain)} parameters; all {len(qkv)} query/key/value weights finite, smallest max|g| {smallest:.3e}; "
          f"{cfg.n_layers} forward, dQ and dK/dV launches each, {F32_STEP_ROUTES}")


def card_vs_cpu_training() -> None:
    """Two f32 train steps on 6×6 puzzles on the card and on the CPU, with
    the same draws (made on the CPU): the loss within 1e-4 relative, and the
    parameters after two steps within 1e-3 of each parameter's largest step
    (gradients agree to ~1e-5 through another order of sums; Adafactor
    normalises them). Where an unfactored parameter's gradient is within
    rounding noise of 0, the direction of its step is set by that noise in
    either run: there the step is only held to Adafactor's clip, an RMS of at
    most lr·max(RMS(param), 1e-3). On the card each step launches the
    forward, dQ and dK/dV on the tensor cores (N = 44: 36 pieces + 8 virtual
    nodes)."""
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
        before_routes = read_routes()
        for _ in range(2):
            state, aux = step(state, batch)
            losses.append(float(aux["total_loss"]))
        if device == "cuda" and by_route(routes_since(before_routes)) != f32_step_routes_2d(2 * cfg.n_layers):
            raise AssertionError(f"6x6 f32 train steps: launches by route {routes_since(before_routes)}")
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


def drive_trainer(argvs: list[list[str]], label: str, cli=None) -> tuple[list[dict], list[int]]:
    """Run a 2D CLI's ``main`` (default the rotation CLI's; ``run_2d``, the
    ``Trainer``) once per argv; each train step is timed (host clock to a
    synchronize, and CUDA events), its launches counted and its puzzles'
    valid pieces recorded. Returns (steps, the number of steps of each run)."""
    import torch

    from diffassemble_tpu_torch.cli import train_2d_rot
    from diffassemble_tpu_torch.train import trainer as trainer_mod

    cli = cli or train_2d_rot

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
                   "valid": batch.node_mask.sum(-1).tolist(),
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
            with mock.patch.object(sys, "argv", [cli.__name__.rsplit(".", 1)[-1], *argv]):
                cli.main()
            runs.append(len(steps) - before)
    return steps, runs


def training(run_dir: Path) -> tuple[dict[str, int], dict[str, dict[str, int]], list[float], dict]:
    """The second main path: ``run_2d`` of the rotation CLI at full width,
    batch 8, 30×30; then a resume from its checkpoint. Each train step is
    timed (host clock to a synchronize) and its launches counted. Returns
    (launches, by route, the steady steps' host seconds, those steps' host
    seconds and CUDA-event ms with the peak memory)."""
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
    steady_ms = [s["ms"] for i, s in enumerate(steps) if i not in (0, first_run)]
    return counts, routes, steady, {"host_s": steady, "cuda_ms": steady_ms, "max_memory_allocated": peak}


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
    fully connected graph (as ``cli/serve.py`` serves) and in calls of 8.

    Last the same weights in float32 (``compute_dtype="float32"``, the
    model's default precision) over the same puzzles and the candidate the
    gate chose, in calls of 32 (N = 908): every call exactly
    ``per_call`` (120) forward launches, all ``masked_attention_fwd_tc_f32``
    on the tensor cores, and its piece_acc within PIECE_ACC_TOL of the bf16
    run's over that candidate; each call timed by CUDA events and the host
    clock, with the run's peak memory. Its launches are their own path
    (``result["float32"]``)."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch import convert
    from diffassemble_tpu_torch.data import expander_mask
    from diffassemble_tpu_torch.models import Diffusion2D
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
    if counts != launches_of(fwd=n_calls * per_call):
        raise AssertionError(f"expected {n_calls * per_call} forward launches and no backward launch")
    if routes["masked_attention_fwd"] != on_routes(tensor_cores=n_calls * per_call):
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

    # float32: the same weights, puzzles and expander candidate, every forward on the f32 tensor-core kernel
    del model
    torch.cuda.empty_cache()
    f32 = Diffusion2D(dataclasses.replace(cfg, compute_dtype="float32"), device="cuda")
    f32.load_state_dict(convert.load_jax_npz(ASSET)[0], strict=True)
    f32_calls, f32_sample = [], f32.sample

    def f32_timed_sample(*args, **kwargs):
        """``f32.sample`` timed by CUDA events and the host clock, its launches held to ``per_call``."""
        before_call = read_routes()
        host = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = f32_sample(*args, **kwargs)
        ev[1].record()
        torch.cuda.synchronize()
        f32_calls.append({"puzzles": args[0].patches.shape[0], "ms": ev[0].elapsed_time(ev[1]),
                          "host_s": time.perf_counter() - host})
        f32_forward_launches(before_call, per_call, "f32 held-out call")
        return out

    f32.sample = f32_timed_sample
    cand = candidates[int(nearest.split()[-1])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, before_routes = read_counts(), read_routes()
    m = heldout_eval(f32, data._replace(adj=cand), rot_k, eval_n=EVAL_N)
    f32_counts = {k: v - before[k] for k, v in read_counts().items()}
    f32_routes = routes_since(before_routes)
    f32_peak = torch.cuda.max_memory_allocated()
    bf16_acc = by_graph[nearest]["piece_acc"]
    f32_gap = abs(m["overall__piece_acc"] - bf16_acc)
    for c in f32_calls:
        phase(f"held-out call of {c['puzzles']} puzzles, f32: {c['ms']:.2f} ms (CUDA events), {c['host_s']:.3f} s host; "
              f"{per_call} forward launches, all masked_attention_fwd_tc_f32 on the tensor cores")
    phase(f"held-out accuracy, f32, {nearest}: piece_acc {m['overall__piece_acc']!r} against bf16's {bf16_acc!r} "
          f"(gap {f32_gap:.5f}, tolerance {PIECE_ACC_TOL}), puzzle_acc {m['overall_acc']!r}; launches {f32_counts}; "
          f"max_memory_allocated {f32_peak / 2**30:.2f} GiB")
    if f32_counts != launches_of(fwd=n_calls * per_call) or len(f32_calls) != n_calls \
            or m["overall_nImages"] != EVAL_TOTAL or not f32_gap <= PIECE_ACC_TOL:
        raise AssertionError(f"f32 held-out eval: piece_acc {m['overall__piece_acc']} against bf16's {bf16_acc}, "
                             f"launches {f32_counts} in {len(f32_calls)} calls")
    result["float32"] = {"piece_acc": m["overall__piece_acc"], "puzzle_acc": m["overall_acc"],
                         "bf16_piece_acc": bf16_acc, "expander": nearest, "calls": f32_calls,
                         "max_memory_allocated": f32_peak, "launches": f32_counts, "routes": f32_routes}
    return counts, routes, result


def recipe_argv(run_dir: str, data_recipe: dict, max_steps: int, train_n: int, eval_n: int, eval_every: int,
                backbone: str | None = None, encoder_init: bool = True, config: Path = CONFIG,
                batch: int = TRAIN_BATCH, ema_decay: float = EMA_DECAY) -> list[str]:
    """``cli/train_device.py``'s flags for a run's config.json (default the
    flagship's: widths, sampler, backbone and, with ``encoder_init``, its
    pretrained encoder) and a data recipe (``data.json``: sizes, graph, image
    knobs, seed), at ``batch`` with ``ema_decay``, cut to the given corpora
    and steps; each evaluation draws its first puzzle as the recipe's default
    ``--viz_every_eval 1`` does (an ``.npy`` of the pixels where PIL is
    missing, as on the card)."""
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
        "--seed", str(data_recipe["seed"]), "--ema_decay", str(ema_decay), "--device", "cuda",
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
    step_want = launches_of(4, 4, 4)
    step_routes = {k: on_routes(tensor_cores=n) for k, n in step_want.items()}
    for s in steps:
        if s["launches"] != step_want or by_route(s["routes"]) != step_routes:
            raise AssertionError(f"{label} step {s['step']}: launches {s['launches']} by route {s['routes']}, "
                                 f"expected {step_want}, all on the tensor cores")
        if not (math.isfinite(s["total_loss"]) and math.isfinite(s["grad_norm"]) and s["grad_norm/encoder"] > 0
                and s["grad_norm/denoiser"] > 0):
            raise AssertionError(f"{label} step {s['step']}: bad loss or gradient norms {s}")
    for e in evals:
        n = per_call * e["calls"]
        if (e["launches"] != launches_of(fwd=n)
                or e["routes"]["masked_attention_fwd"] != on_routes(tensor_cores=n)):
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
    # every evaluation drew its first puzzle (the default --viz_every_eval 1): a PNG, or its pixels as .npy
    drawn = sorted(p.name for p in (run_dir / "viz").iterdir())
    if len(drawn) != len(evals) + len(more_evals) or not all(f.endswith((".png", ".png.npy")) for f in drawn):
        raise AssertionError(f"recipe reconstructions: {drawn}")
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
          f"{corpus} bytes on the device; checkpoints {first} then {after}; launches {counts}; "
          f"reconstructions {drawn}")
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
    versions (on the tensor cores in bf16 and f32; at Dh 32 and 144, the same
    tolerances and exact zeros as every other mask), then timed in both
    types (``time_on_masks``)."""
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
    return time_on_masks(mask, label, MAIN_HEAD_DIMS, gen) + time_on_masks(mask, label, MAIN_HEAD_DIMS, gen,
                                                                           dtype="float32")


def time_on_masks(mask, label: str, widths, gen, heads: int = HEADS, dtype: str = "bfloat16") -> list[dict]:
    """The kernels timed on ``mask`` at each head width in ``dtype``, beside
    their plain versions, the bound over the mask's attended pairs (the
    small-graph kernels' reads also over its rows with an edge) and
    ``scaled_dot_product_attention`` with the same boolean mask (its forward,
    and one backward for dQ, dK and dV together): the forward, and the
    backward its route takes, dQ and dK/dV or the fused kernel. A fused row,
    and a float32 dQ or dK/dV row on the tensor cores, carries the CUDA-core
    dQ + dK/dV pair on the same inputs (``cuda_core_pair_ms``), and a
    small-graph forward row, or a float32 forward row on the tensor cores, the
    CUDA-core forward (``cuda_core_fwd_ms``). One
    row a kernel and width, with the C function its route launches
    (``cuda_attention.c_function``); the caller adds its launches
    (``attach_launches_2d``)."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    b, n, _ = mask.shape
    pairs = int(mask.sum())
    edges = (int(mask.any(-1).sum()), int(mask.any(-2).sum()))
    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt = getattr(torch, dtype)
    short = {"bfloat16": "bf16", "float32": "f32"}[dtype]
    for dh in widths:
        q, k, v, dout = (torch.randn((b, n, heads, dh), generator=gen, device="cuda").to(dt) for _ in range(4))
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
        cases = [("masked_attention_fwd", lambda: ca.masked_attention_fwd(q, k, v, mask),
                  lambda: ca.masked_attention_fwd_plain(q, k, v, mask), lib_fwd)]
        fused = ca.route(ca.BACKWARD_PAIR[0], *args) == "small_graph"
        if fused:
            cases.append((FUSED, lambda: ca.masked_attention_bwd_small(q, k, v, mask, dout, o, lse),
                          lambda: ca.masked_attention_bwd_small_plain(q, k, v, mask, dout, o, lse), lib_bwd))
        else:
            cases += [("masked_attention_bwd_dq", lambda: ca.masked_attention_bwd_dq(*args),
                       lambda: ca.masked_attention_bwd_dq_plain(*args), lib_bwd),
                      ("masked_attention_bwd_dkv", lambda: ca.masked_attention_bwd_dkv(*args),
                       lambda: ca.masked_attention_bwd_dkv_plain(*args), lib_bwd)]
        for kernel, fn, plain, library_ms in cases:
            ms, plain_ms = cuda_ms(fn), cuda_ms(plain)
            route = ca.route(kernel, *args)
            function = ca.c_function(kernel, route, dt)
            small = route == "small_graph"  # the small-graph forward or the fused backward
            bound, bound_by = bound_ms(function if small else kernel, b, n, heads, dh, q.element_size(),
                                       pairs=pairs, edges=edges)
            here.append({"kernel": kernel, "function": function, "b": b, "n": n, "h": heads, "dh": dh,
                         "dtype": dtype, "route": route, "main_path": True, "mask": label, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by,
                         **({"edges": list(edges)} if small else {})})
            phase(f"timing {function:31s} B={b} N={n} H={heads} Dh={dh:3d} {short} {route:12s} ({label}): kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
                  f"bound {bound:.6f} ms ({bound_by})")
        if here[0]["route"] == "small_graph" or dtype == "float32":
            _beside_cuda_core_fwd(here[0], q, k, v, mask, heads, label)
        pair = here[1]["ms"] + (0.0 if fused else here[2]["ms"])
        if fused or dtype == "float32":
            old = cuda_core_pair_ms(q, k, v, mask, dout, o, lse)
            for row in here[1:]:
                row["cuda_core_pair_ms"] = old
            cc_pair = old["dq_ms"] + old["dkv_ms"]
            beside = (f"against the CUDA-core pair dQ {old['dq_ms']:.4f} + dK/dV {old['dkv_ms']:.4f} = {cc_pair:.4f} "
                      f"ms (and its Δ {old['delta_ms']:.4f} ms): {cc_pair / pair:.2f}x faster; ")
        else:
            beside = ""
        bound = sum(r["bound_ms"] for r in here[1:])
        phase(f"timing {'fused backward' if fused else 'backward pair':24s} B={b} N={n} H={heads} Dh={dh:3d} {short} "
              f"{here[1]['route']:12s}: {pair:.4f} ms {beside}against one SDPA backward {lib_bwd:.4f} ms: "
              f"{pair / lib_bwd:.2f}x; {pair / bound:.1f}x the bound"
              + (f" (reads over {edges[0]} query rows with an edge and {edges[1]} attended keys of B·N = {b * n})"
                 if fused else ""))
        rows += here
        del out_t, qt, kt, vt
    return rows


def cuda_core_pair_ms(q, k, v, mask, dout, o, lse) -> dict[str, float]:
    """The CUDA-core dQ and dK/dV kernels (``csrc/masked_attention_bwd.cu``)
    through the library's C entry points, uncounted, with the Δ they need: on
    a small graph's inputs (the wrappers give a graph of at most
    ``SMALL_GRAPH_N`` nodes to the fused kernel) and on f32 inputs at the main
    widths (the wrappers give them to the tensor cores). Each is timed after
    their outputs are held to the fused kernel's plain version (the pair's
    with that Δ) within phase 3's tolerance for the type. Their times beside
    the fused kernel's, or the f32 tensor-core pair's, come from one run."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    lib = ca.load_library()
    b, n, h, dh = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    delta = ca.attention_delta(dout, o)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))

    def call(name, *outs):
        rc = lib.fn(name)(*(t.data_ptr() for t in (q, k, v, mask, dout, lse, delta, *outs)), b, n, h, dh,
                          ca._DTYPES[q.dtype], 1.0 / math.sqrt(dh), stream)
        if rc != 0:
            raise RuntimeError(f"{name} failed: CUDA error {rc}")

    call("masked_attention_bwd_dq", dq)
    call("masked_attention_bwd_dkv", dk, dv)
    torch.cuda.synchronize()
    rel, floor = (1e-5, 1e-5) if q.dtype == torch.float32 else (2.0**-7, 1e-4)
    for got, ref in zip((dq, dk, dv), ca.masked_attention_bwd_small_plain(q, k, v, mask, dout, o, lse)):
        rf = ref.float()
        if not bool(((got.float() - rf).abs() <= rel * rf.abs() + floor * rf.abs().max()).all()):
            raise AssertionError(f"the CUDA-core pair disagrees with the plain version at B={b} N={n} Dh={dh}")
    return {"dq_ms": cuda_ms(lambda: call("masked_attention_bwd_dq", dq)),
            "dkv_ms": cuda_ms(lambda: call("masked_attention_bwd_dkv", dk, dv)),
            "delta_ms": cuda_ms(lambda: ca.attention_delta(dout, o))}


def cuda_core_fwd_ms(q, k, v, mask) -> float:
    """The CUDA-core forward (``csrc/masked_attention_fwd.cu``) through the
    library's C entry point, uncounted, on inputs the wrappers give another
    kernel: a small graph's (at most ``SMALL_GRAPH_N`` nodes off the tensor
    cores: the small-graph forward) and f32 inputs at the main widths (the
    tensor cores, 3xTF32). Timed after its O and L are held to the plain
    version within phase 3's tolerances (exact zeros and L on the rows with
    no edges). Its time beside the other kernel's comes from one run."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    lib = ca.load_library()
    b, n, h, dh = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    o, lse = torch.empty_like(q), torch.empty((b, h, n), dtype=torch.float32, device=q.device)

    def call():
        rc = lib.fn("masked_attention_fwd")(*(t.data_ptr() for t in (q, k, v, mask, o, lse)), b, n, h, dh,
                                            ca._DTYPES[q.dtype], 1.0 / math.sqrt(dh), stream)
        if rc != 0:
            raise RuntimeError(f"masked_attention_fwd failed: CUDA error {rc}")

    call()
    torch.cuda.synchronize()
    o_p, lse_p = ca.masked_attention_fwd_plain(q, k, v, mask)
    opf, vmax = o_p.float(), v.float().abs().max()
    tol = (1e-5 * opf.abs() + 1e-5 * vmax if q.dtype == torch.float32 else 2.0**-7 * opf.abs() + 2.0**-9 * vmax)
    empty = ~mask.any(-1)
    rows = empty[:, None, :].expand(b, h, n)
    if not (bool(((o.float() - opf).abs() <= tol).all()) and bool((o[empty] == 0).all())
            and bool(((lse - lse_p).abs()[~rows] <= 1e-5 * (1 + lse_p.abs()[~rows])).all())
            and torch.equal(lse[rows], lse_p[rows])):
        raise AssertionError(f"the CUDA-core forward disagrees with the plain version at B={b} N={n} Dh={dh}")
    return cuda_ms(call)


def _beside_cuda_core_fwd(row: dict, q, k, v, mask, heads: int, label: str) -> None:
    """A small-graph or float32 tensor-core forward row gets the CUDA-core
    forward it replaced, timed on the same inputs (``cuda_core_fwd_ms``), and
    a line that sets the two beside SDPA and the bound."""
    row["cuda_core_fwd_ms"] = old = cuda_core_fwd_ms(q, k, v, mask)
    b, n, dh = row["b"], row["n"], row["dh"]
    reads = (f"reads over {row['edges'][0]} query rows with an edge and {row['edges'][1]} attended keys of "
             f"B·N = {b * n}; " if "edges" in row else "")
    phase(f"timing {row['function']:31s} B={b} N={n} H={heads} Dh={dh:3d} {row['dtype']} {row['route']}: "
          f"{row['ms']:.4f} ms against the CUDA-core forward {old:.4f} ms: {old / row['ms']:.2f}x faster; against "
          f"SDPA {row['library_ms']:.4f} ms: {row['ms'] / row['library_ms']:.2f}x; {row['ms'] / row['bound_ms']:.1f}x "
          f"its bound ({reads}{label})")


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
    if counts != launches_of(3 * 4, 3 * 4, 3 * 4):
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
    existing tolerances and exact zeros on empty rows; the small-graph
    forward at all but bf16 Dh 32), then timed in bf16
    (``time_forward_on_mask``: the small-graph row beside the CUDA-core
    forward it replaced)."""
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


def time_forward_on_mask(mask, label: str, heads: int, widths, gen, dtype: str = "bfloat16") -> list[dict]:
    """The forward kernel timed on ``mask`` at each head width in ``dtype``,
    beside its plain version, the bound over the mask's attended pairs (the
    small-graph forward's reads over its rows with an edge) and
    ``scaled_dot_product_attention`` with the same boolean mask, a
    small-graph or float32 row also beside the CUDA-core forward it replaced
    (``cuda_core_fwd_ms``): one row a width; the caller adds its launches."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    b, n, _ = mask.shape
    pairs = int(mask.sum())
    edges = (int(mask.any(-1).sum()), int(mask.any(-2).sum()))
    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt = getattr(torch, dtype)
    for dh in widths:
        q, k, v = (torch.randn((b, n, heads, dh), generator=gen, device="cuda").to(dt) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        with torch.no_grad():
            library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask[:, None]))
        ms = cuda_ms(lambda: ca.masked_attention_fwd(q, k, v, mask))
        plain_ms = cuda_ms(lambda: ca.masked_attention_fwd_plain(q, k, v, mask))
        route = ca.route("masked_attention_fwd", q, k, v, mask)
        small = route == "small_graph"
        bound, bound_by = bound_ms(FWD_SMALL if small else "masked_attention_fwd", b, n, heads, dh, q.element_size(),
                                   pairs=pairs, edges=edges)
        rows.append({"kernel": "masked_attention_fwd",
                     "function": ca.c_function("masked_attention_fwd", route, q.dtype), "b": b, "n": n, "h": heads,
                     "dh": dh, "dtype": dtype, "route": route, "main_path": True, "mask": label, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by,
                     **({"edges": list(edges)} if small else {})})
        phase(f"timing masked_attention_fwd      B={b} N={n} H={heads} Dh={dh:3d} {dtype} {route:12s} ({label}): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
              f"bound {bound:.6f} ms ({bound_by})")
        if small or dt == torch.float32:
            _beside_cuda_core_fwd(rows[-1], q, k, v, mask, heads, label)
    return rows


def _finite(m: dict) -> bool:
    return all(math.isfinite(v) for v in m.values() if isinstance(v, float)) and all(
        _finite(v) for v in m.values() if isinstance(v, dict))


def cli_evaluate_3d(run_dir: Path, model, cfg, step: int, protocol: dict, *extra: str):
    """A trained model written as a run of the port (config.json and a
    checkpoint of ``train/checkpoint.py``) and evaluated by
    ``cli/train_3d.py``'s ``run_3d --evaluate`` (with the flags ``extra``)
    over the protocol's corpus in calls of its batch: (the CLI's metrics,
    seconds, launches, launches by route), the launches counted from 0."""
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
        "--synthetic_canonical", str(p["canonical"]), "--seed", str(p["seed"]), "--device", "cuda", *extra])
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
    90 on the tensor cores (Dh 32) and 30 on the small-graph route (Dh 264,
    N = 8: ``csrc/masked_attention_fwd_small.cu``), no backward launch. The
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
    layer's on the small-graph route (N <= 32) and the others' on the tensor
    cores, none on the CUDA cores, no backward launch. Gates: those launches, n_parts (``N_PARTS_3D_ASSETS``),
    finite metrics, the zero-noise calibration row at part_acc 1.0, and each
    key of ``TOL_3D_ASSETS`` that the row has within its tolerance of the
    JAX package's CPU run in the checkpoint's type (``JAX_CPU_3D_ASSETS``).
    Returns the protocol runs' launches, by route, the result, and each
    ratio's calls."""
    from diffassemble_tpu_torch.train.heldout3d import calibration, protocol_corpus, protocol_ratios

    n_calls = -(-protocol["test_n"] // protocol["batch"])

    def want(ratio):
        steps = cfg.steps // ratio
        return cfg.n_layers * steps, on_routes(tensor_cores=(cfg.n_layers - 1) * steps, small_graph=steps)

    per_call, want_routes = want(cfg.inference_ratio)
    cli, cli_seconds, cli_counts, cli_routes = cli_evaluate_3d(run_dir, model, cfg, step, protocol)
    phase(f"{name} run_3d --evaluate: {cli_seconds:.2f} s, launches {cli_counts}, forward by route "
          f"{cli_routes['masked_attention_fwd']}; rmse_t_AVG {cli['rmse_t_AVG'][0]!r}, rmse_r_AVG "
          f"{cli['rmse_r_AVG'][0]!r}, gd_r_AVG {cli['gd_r_AVG'][0]!r}, part_acc_AVG {cli['part_acc_AVG'][0]!r}")
    if cli_counts != launches_of(fwd=n_calls * per_call):
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

    counts = launches_of()
    routes = {**{k: on_routes() for k in WRAPPERS}, FUNCTIONS: {}}
    out, calls_by_ratio = {"cli": {k: m for k, (m, _) in cli.items()}, "cli_seconds": cli_seconds,
                           "cli_launches": cli_counts, "cli_routes": cli_routes, "calibration": calib,
                           "rows": []}, {}
    for ratio in protocol_ratios(protocol):
        ratio = ratio or cfg.inference_ratio
        per_call, want_routes = want(ratio)
        result, calls, c_counts, c_routes, peak = timed_protocol_3d(model, protocol, ratio)
        for k in WRAPPERS:
            counts[k] += c_counts[k]
        for k, by in c_routes.items():
            for r, n in by.items():
                routes[k][r] = routes[k].get(r, 0) + n
        for c in calls:
            phase(f"{name} held-out call, ratio {ratio}, {c['objects']} objects ({c['parts']} parts): "
                  f"{c['ms']:.2f} ms (CUDA events), {c['host_s']:.3f} s host, launches {c['launches']}, forward by "
                  f"route {c['routes']['masked_attention_fwd']}")
            if c["launches"] != launches_of(fwd=per_call) or c["routes"]["masked_attention_fwd"] != want_routes:
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


def head_widths_3d(cfg) -> tuple[int, int]:
    """The 3D denoiser's two head widths with the easy run's flags: the
    hidden width's and the encoder's features' (vn_dgcnn_rich's 2048:
    equivariant 1536 ‖ invariant 512) with the 64 of the pose, each over the
    heads."""
    feat_dim = 2048
    return cfg.hidden_dim // cfg.heads, (feat_dim + 64) // cfg.heads


def train3d_kernels(nb, widths: tuple[int, int], max_err: dict[str, float]) -> list[dict]:
    """The kernels on the 3D training masks (the run's first batch: B = 16,
    N = 8, padding parts with empty query rows and unattended keys): the
    backward, after the forward, against its plain version at the
    denoiser's head widths, Dh 32 (bf16: dQ and dK/dV on the tensor cores;
    f32: fused) and 264 (fused), in bf16 and f32 with phase 3's tolerances,
    exact zeros and routes; then timed (``time_on_masks``)."""
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
        if launched != (launches_of() if swap else counts_of(step_routes_3d(passes, cfg.n_layers, "float32"))):
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
    counted, and each step's Δ computations outside the fused kernel
    (``attention_delta`` calls, ``delta_calls``), evaluating every
    ``eval_every`` steps (the CLI's is every 1000). The launches are counted
    from 0. Returns (the steps, the evaluations, (steps so far, checkpoints)
    after each run, seconds, peak memory)."""
    import torch

    from diffassemble_tpu_torch.cli import train_3d
    from diffassemble_tpu_torch.ops import cuda_attention as ca
    from diffassemble_tpu_torch.train import trainer as trainer_mod

    steps, evals, runs = [], [], []
    make_step = trainer_mod.make_train_step
    attention_delta, delta_calls = ca.attention_delta, [0]

    def counted_delta(dout, o):
        delta_calls[0] += 1
        return attention_delta(dout, o)

    def counted_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def counted(state, batch):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t0, before, before_routes, deltas = time.perf_counter(), read_counts(), read_routes(), delta_calls[0]
            ev[0].record()
            new, aux = step(state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            rec = {"step": new.step, "seconds": time.perf_counter() - t0, "ms": ev[0].elapsed_time(ev[1]),
                   "launches": {k: v - before[k] for k, v in read_counts().items()},
                   "routes": routes_since(before_routes), "delta_calls": delta_calls[0] - deltas,
                   **{k: float(v) for k, v in aux.items()}}
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
            mock.patch.object(trainer_mod, "Trainer", EvaluatedTrainer), \
            mock.patch.object(ca, "attention_delta", counted_delta):
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
    resume to step 6. Gates: every step exactly 8 forward launches, 6 on the
    tensor cores (Dh 32) and 2 on the small-graph route (Dh 264), 6 dQ and 6 dK/dV
    launches on the tensor cores with a Δ each, 2 fused backward launches on
    the small-graph route (Dh 264, N = 8) and no Δ for them, finite
    losses and gradient norms, nonzero gradients in the encoder, the pairwise
    head and the denoiser; every evaluation 120 forward launches a call of 16
    objects and no backward; the checkpoints and the resume. Returns the
    run's launches, by kernel and by route, its result and the kernel rows."""
    from diffassemble_tpu_torch.cli import train_3d

    start = time.perf_counter()
    nb, draws = loss_inputs_3d()
    cfg = train_3d.config_from_args(train3d_args(""))
    widths = head_widths_3d(cfg)
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

    route_want = step_routes_3d(2, cfg.n_layers)
    step_want = counts_of(route_want)
    if first_run != TRAIN3D_STEPS or [s["step"] for s in steps] != list(range(1, TRAIN3D_RESUME_TO + 1)):
        raise AssertionError(f"3D training: steps {[s['step'] for s in steps]}, the first run {first_run}")
    for s in steps:
        deltas = step_want["masked_attention_bwd_dq"]  # one Δ a tensor-core dQ launch, none for the fused
        if (s["launches"], by_route(s["routes"]), s["delta_calls"]) != (step_want, route_want, deltas):
            raise AssertionError(f"3D train step {s['step']}: launches {s['launches']} by route {s['routes']}, "
                                 f"{s['delta_calls']} Δ outside the fused kernel; expected {step_want}, {route_want}, "
                                 f"one Δ a dQ launch")
        if not (all(math.isfinite(v) for k, v in s.items() if isinstance(v, float)) and s["grad_nonfinite"] == 0
                and min(s["grad_norm/encoder"], s["grad_norm/rel_head"], s["grad_norm/denoiser"]) > 0):
            raise AssertionError(f"3D train step {s['step']}: bad loss or gradient norms {s}")
    for e in evals:
        n = per_call * e["calls"]
        if (e["calls"] != 1 or e["launches"] != launches_of(fwd=n)
                or e["routes"]["masked_attention_fwd"] != on_routes(tensor_cores=n * 3 // 4, small_graph=n // 4)):
            raise AssertionError(f"3D evaluation: {e}, expected {per_call} forward launches a call (3/4 on the "
                                 f"tensor cores) and no backward")
    if [(e["tag"], e["step"]) for e in evals] != [("sanity", 0), ("val", TRAIN3D_STEPS), ("sanity", 0)]:
        raise AssertionError(f"3D evaluations {[(e['tag'], e['step']) for e in evals]}")
    if first_ckpts != [TRAIN3D_STEPS] or ckpts != [TRAIN3D_STEPS, TRAIN3D_RESUME_TO]:
        raise AssertionError(f"3D checkpoints {first_ckpts}, then {ckpts}")
    if len({(r["kernel"], r["route"]) for r in rows}) != len(rows):
        raise AssertionError(f"3D training: a kernel at the head widths {widths} shares a route, so its "
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
    """The kernels at every head width the 3D family gives them, on the 3D
    protocols' own masks: N = 8 (``diffusion3d_easy``'s first call, 2–8
    parts) and N = 20 (``diffusion3d_vndgcnn``'s, 2–20 parts: most rows are
    padding, with empty query rows and unattended keys), against their plain
    versions in bf16 and f32 with phase 3's tolerances, exact zeros and
    routes: the forward and the backward on their route, the small-graph
    forward and the fused kernel at every width but bf16 Dh 32 (the tensor
    cores' forward, dQ and dK/dV), and at Dh 32 and 144 for bf16 inputs 2
    bytes off a 16-byte boundary. On the N =
    20 mask at Dh 271, ``MaskedAttention``'s backward in both types is one
    fused launch and computes no Δ outside it (``fused_backward_alone``).
    Then timed in bf16 where a main path launches them (``time_on_masks``):
    at N = 20 Dh 32 (every N = 20 path), 24 (``pointnet``), 40
    (``pointnet_plus``), 104 (``diffusion3d_vndgcnn``), 136
    (``pointnet_inv``) and 271 (``vnn``), at N = 8 Dh 136 (split message
    passing); each fused row beside the CUDA-core pair it replaced. Returns
    the timed rows, each with its mask's N."""
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
        for dh in MAIN_HEAD_DIMS:  # bf16 2 bytes off a 16-byte boundary: the small-graph route at the TC widths
            _check_kernels(label, mask, dh, torch.bfloat16, gen, max_err, misaligned=True)
        if name == "diffusion3d_vndgcnn":
            for dtype in (torch.bfloat16, torch.float32):
                fused_backward_alone(mask, 271, dtype, gen)
        rows += time_on_masks(mask, label, timed, gen)
    return rows


def fused_backward_alone(mask, dh: int, dtype, gen) -> None:
    """``MaskedAttention`` forward and backward on a small graph off the
    tensor cores: the backward launches the fused kernel once and nothing
    else (no dQ or dK/dV launch, no Δ computed outside it: ``attention_delta``
    raises meanwhile), and its gradients are bit-equal to the fused kernel's
    called on the forward's O and L (it is deterministic)."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    b, n, _ = mask.shape
    q, k, v, dout = (torch.randn((b, n, HEADS, dh), generator=gen, device="cuda").to(dtype) for _ in range(4))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = ca.MaskedAttention.apply(q, k, v, mask)

    def no_delta(*args):
        raise AssertionError("Δ computed outside the fused kernel")

    before = read_counts()
    with mock.patch.object(ca, "attention_delta", no_delta):
        out.backward(dout)
    torch.cuda.synchronize()
    launched = {kern: c - before[kern] for kern, c in read_counts().items()}
    o, lse = ca.masked_attention_fwd(q.detach(), k.detach(), v.detach(), mask)
    want = ca.masked_attention_bwd_small(q.detach(), k.detach(), v.detach(), mask, dout, o, lse)
    equal = all(torch.equal(g, w) for g, w in zip((q.grad, k.grad, v.grad), want))
    phase(f"MaskedAttention backward B={b} N={n} H={HEADS} Dh={dh} {str(dtype)[6:]}: launches {launched}, no Δ "
          f"outside the fused kernel, gradients bit-equal to the fused kernel's {equal}")
    if launched != launches_of(fused=1) or not equal:
        raise AssertionError(f"MaskedAttention's backward on a small graph: launches {launched}, equal {equal}")


def eval3d_more(workdir: Path) -> dict[str, tuple]:
    """The eighth main path: the three other trained 3D checkpoints
    (``MORE_ASSETS_3D``) through ``run_3d --evaluate`` and ``heldout3d``'s
    protocol (``protocol_runs_3d``): ``diffusion3d_relpose`` and
    ``diffusion3d_wallsurf`` (its refined row too) at ratio 10,
    ``diffusion3d_vndgcnn`` (N = 20, Dh 104 on the small-graph route) at ratios 10
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
    """Each step: the denoiser's passes × layers forward launches, one
    layer's (head width ``width``) on the small-graph route and the others'
    on the tensor cores; the backward of that layer fused (the small-graph route),
    the others' dQ and dK/dV on the tensor cores, Δ computed once for each
    of those and never for the fused (``step_routes_3d``); finite losses and
    gradient norms, every group's gradient nonzero. Each evaluation: one
    call, the layers × reverse steps forward launches, no backward."""
    passes = 2 if cfg.aux_pose_weight > 0 else 1
    route_want = step_routes_3d(passes, cfg.n_layers)
    step_want = counts_of(route_want)
    for s in steps:
        deltas = step_want["masked_attention_bwd_dq"]  # one Δ a tensor-core dQ launch, none for the fused
        if (s["launches"], by_route(s["routes"]), s["delta_calls"]) != (step_want, route_want, deltas):
            raise AssertionError(f"{label} step {s['step']}: launches {s['launches']} by route {s['routes']}, "
                                 f"{s['delta_calls']} Δ outside the fused kernel; expected {step_want}, {route_want} "
                                 f"(Dh {width}: the forward and the backward on the small-graph route), one Δ a dQ "
                                 f"launch")
        norms = [v for k, v in s.items() if k.startswith("grad_norm/")]
        if not (all(math.isfinite(v) for v in s.values() if isinstance(v, float)) and s["grad_nonfinite"] == 0
                and len(norms) >= 2 and min(norms) > 0):
            raise AssertionError(f"{label} step {s['step']}: bad loss or gradient norms {s}")
    reverse = cfg.steps // cfg.inference_ratio
    per_call = cfg.n_layers * reverse
    for e in evals:
        if (e["calls"] != 1 or e["launches"] != launches_of(fwd=per_call)
                or e["routes"]["masked_attention_fwd"] != on_routes(tensor_cores=(cfg.n_layers - 1) * reverse,
                                                                    small_graph=reverse)):
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
    run the same sizes and padding over their own corpus. The f32 rows get
    none: these paths run in bf16."""
    for r in rows:
        if r["dtype"] == "float32":
            continue
        r["launches_by_path"] = {path: [rec["routes"][r["kernel"]][r["route"]] for rec in recs]
                                 for path, recs in paths[r["mask"]].items()}
    return rows


def _gate_2d(name: str, metrics: dict, calls: list[dict], counts: dict, routes: dict, label: str) -> dict:
    """The trained checkpoint's gate: piece_acc within ``PIECE_ACC_TOL`` of the
    TPU's, every forward launch on the tensor cores, 120 a call, no backward."""
    per_call = 4 * (300 // 10)
    n = per_call * len(calls)
    if counts != launches_of(fwd=n) or routes["masked_attention_fwd"] != on_routes(tensor_cores=n):
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
    protocol's masks (on the tensor cores in bf16 and f32; Dh 32 and 144,
    exact zeros), then timed there in both types (``time_on_masks``)."""
    import torch

    label, mask = discrete_masks()
    b, n, _ = mask.shape
    pairs = int(mask.sum())
    phase(f"discrete masks: {label}, B={b} N={n}, {pairs} attended pairs ({pairs / mask.numel():.3f} of B·N²)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dh in MAIN_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            _check_kernels(label, mask, dh, dtype, gen, max_err)
    return time_on_masks(mask, label, MAIN_HEAD_DIMS, gen) + time_on_masks(mask, label, MAIN_HEAD_DIMS, gen,
                                                                           dtype="float32")


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
    in_steps = {k: sum(s["launches"][k] for s in steps) for k in WRAPPERS}
    sanity = {k: counts[k] - in_steps[k] for k in WRAPPERS}  # one sanity call in each run
    if sanity != launches_of(fwd=2 * per_call) or routes["masked_attention_fwd"]["cuda_cores"]:
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


def _check_trainer_steps(steps: list[dict], label: str, launches: int = 4) -> None:
    """Every step ``launches`` of each kernel (default 4 + 4 + 4), all on the
    tensor cores, finite, with gradients in encoder and denoiser."""
    want = launches_of(launches, launches, launches)
    on_tc = {k: on_routes(tensor_cores=n) for k, n in want.items()}
    for s in steps:
        if s["launches"] != want or by_route(s["routes"]) != on_tc:
            raise AssertionError(f"{label} step {s['step']}: launches {s['launches']} by route {s['routes']}")
        if not (math.isfinite(s["total_loss"]) and math.isfinite(s["grad_norm"]) and s["grad_nonfinite"] == 0
                and s["grad_norm/encoder"] > 0 and s["grad_norm/denoiser"] > 0):
            raise AssertionError(f"{label} step {s['step']}: bad loss or gradient norms {s}")


def angle_sample() -> tuple[dict[str, int], dict[str, dict[str, int]], dict]:
    """The fourteenth main path: a seeded 6×6 ``AngleDiffusion2D`` sample
    (rot_ms's widths and encoder, DDIM from unit noise drawn on the CPU).
    First in f32, card against CPU within the 6×6 sample phase's 1e-3 (a
    comparison, its launches not counted on this path: 120, each
    ``masked_attention_fwd_tc_f32``); then in bf16 with the counts from 0:
    120 forward launches on the tensor cores, no backward, a finite (1, 36,
    4) result."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch.models import AngleDiffusion2D, AngleDiffusion2DConfig

    base = dataclasses.asdict(mixed_config())
    cfg = AngleDiffusion2DConfig(**{**base, "compute_dtype": "float32", "noise_weight": 0.0})
    small = seeded_puzzles(6, 1, True, np.random.default_rng(7))
    finals = [AngleDiffusion2D(cfg, device="cpu", seed=0).sample(small.to("cpu")).final]
    before_routes = read_routes()
    finals.append(AngleDiffusion2D(cfg, device="cuda", seed=0).sample(small.to("cuda")).final.cpu())
    launched = f32_forward_launches(before_routes, cfg.n_layers * (cfg.steps // cfg.inference_ratio),
                                    "angle sample f32")
    err = (finals[1] - finals[0]).abs().max().item()
    phase(f"angle model: 6x6 sample f32, card vs CPU: max|d|={err:.3e} (tol 1e-3), final {tuple(finals[1].shape)}; "
          f"{launched}")
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
    if counts != launches_of(fwd=n) or routes["masked_attention_fwd"] != on_routes(tensor_cores=n):
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
    (``serve_masks``) at Dh 32 and 144 on the tensor cores, bf16 and f32,
    then timed there in bf16 (``time_forward_on_mask``)."""
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
    if counts != launches_of(fwd=120) or routes["masked_attention_fwd"] != on_routes(tensor_cores=120):
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


def _tf32(x):
    """f32 → the nearest TF32 value (ties away from zero, as ``cvt.rna``), as f32."""
    import torch

    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _to_f32(x64, rounding: str):
    """f64 → f32, rounded to nearest (``"rn"``) or toward zero (``"rz"``)."""
    import torch

    y = x64.float()
    if rounding == "rz":
        y = torch.where(y.double().abs() > x64.abs(), torch.nextafter(y, torch.zeros_like(y)), y)
    return y


def _mma_chain(eq: str, a, ax_a: int, b, ax_b: int, model: str, acc=None):
    """``acc`` (f32, None for 0) + Σ_k a·b over the steps the f32 tensor-core
    kernels take: 8-wide k-steps in order, each the three m16n8k8 products of
    the operands' TF32 halves (lo·hi, hi·lo, hi·hi), each product's 8 terms
    summed exactly (f64). ``model`` says how they reach the f32 sum: ``"rn"``
    or ``"rz"``, each product added by the tensor cores to the running sum,
    rounded to nearest or toward zero; ``"rz3+rn"``, the three products of a
    step into a zeroed accumulator toward zero, then added to the running sum
    by an f32 add, to nearest (what a kernel that keeps its sums outside the
    tensor cores' accumulator would give)."""
    import torch

    a_hi = _tf32(a)
    b_hi = _tf32(b)
    halves = [(_tf32(a - a_hi).double(), b_hi.double()), (a_hi.double(), _tf32(b - b_hi).double()),
              (a_hi.double(), b_hi.double())]
    k = a.shape[ax_a]
    each = "rz" if model == "rz3+rn" else model
    for k0 in range(0, k, 8):
        w = min(8, k - k0)
        step = None
        for x, y in halves:
            p = torch.einsum(eq, x.narrow(ax_a, k0, w), y.narrow(ax_b, k0, w))
            if model == "rz3+rn":
                step = _to_f32(p if step is None else step.double() + p, each)
            else:
                acc = _to_f32(p if acc is None else acc.double() + p, each)
        if model == "rz3+rn":
            acc = step if acc is None else _to_f32(acc.double() + step.double(), "rn")
    return acc


def _emulate_f32_pair(q, k, v, mask, dout, lse, delta, model: str):
    """dQ, dK and dV as the two f32 tensor-core kernels compute them, their
    products accumulated by ``model`` (``_mma_chain``): S and dP per kernel
    in its own operand order (the dQ kernel Q·Kᵀ, the dK/dV kernel K·Qᵀ),
    P = exp(S·scale − L) with one rounding before the exponential (a fused
    multiply-add), dS = P∘(dP − Δ) in f32, masked entries 0."""
    import torch

    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32).item()
    m = mask.bool()[:, None]
    out = []
    for s_args, dp_args in (((q, 3, k, 3), (dout, 3, v, 3)), ((k, 3, q, 3), (v, 3, dout, 3))):
        eq = "bnhd,bmhd->bhnm" if s_args[0] is q else "bmhd,bnhd->bhnm"
        s = _mma_chain(eq, *s_args, model)
        dp = _mma_chain(eq, *dp_args, model)
        x = (s.double() * scale - lse[..., None].double()).float()
        p = torch.where(m, torch.exp(x), torch.zeros_like(x))
        ds = torch.where(m, p * (dp - delta[..., None]), torch.zeros_like(x))
        out.append((p, ds))
        del s, dp, x
    (_, ds_q), (p_kv, ds_kv) = out
    dq = _mma_chain("bhnm,bmhd->bnhd", ds_q, 3, k, 1, model) * scale
    dk = _mma_chain("bhnm,bnhd->bmhd", ds_kv, 2, q, 1, model) * scale
    dv = _mma_chain("bhnm,bnhd->bmhd", p_kv, 2, dout, 1, model)
    return dq, dk, dv


FWD_F32_KEY_TILE = {32: 64, 144: 16}  # key_tile(DH) in csrc/masked_attention_fwd_tc_f32.cu


def _emulate_f32_fwd(q, k, v, mask, model: str):
    """O and L as the f32 tensor-core forward computes them, its products
    accumulated by ``model``: ``"rn"``, ``"rz"`` or ``"rz3+rn"`` as
    ``_mma_chain`` (S and P·V alike, O rescaled by alpha with an f32 multiply
    and each key tile's products added to it: a kernel that kept O in the
    tensor cores' accumulator), or ``"tile"``, the kernel's: S toward zero
    (rz), each key tile's P·V into a zeroed accumulator toward zero, joined
    to O by an FFMA to nearest, O ← alpha·O + tile. The online softmax over
    the kernel's key tiles in f32, S scaled after its sum, a masked entry
    never exponentiated."""
    import torch

    key_tile = FWD_F32_KEY_TILE[q.shape[-1]]
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32).item()
    s = _mma_chain("bnhd,bmhd->bhnm", q, 3, k, 3, "rz" if model == "tile" else model) * scale
    edges = mask.bool()[:, None]
    b, h, n, _ = s.shape
    m = torch.full((b, h, n), -1e9, device=q.device)
    l = torch.zeros((b, h, n), device=q.device)
    acc = None
    for k0 in range(0, n, key_tile):
        st, et, vt = s[..., k0:k0 + key_tile], edges[..., k0:k0 + key_tile], v[:, k0:k0 + key_tile]
        m_new = torch.maximum(m, torch.where(et, st, -1e9).amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(et, torch.exp(st - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        if model == "tile":
            pv = _mma_chain("bhnm,bmhd->bhnd", p, 3, vt, 1, "rz")
            acc = pv if acc is None else _to_f32(alpha.double()[..., None] * acc.double() + pv.double(), "rn")
        else:
            acc = _mma_chain("bhnm,bmhd->bhnd", p, 3, vt, 1, model, None if acc is None else acc * alpha[..., None])
        m = m_new
    denom = l.clamp_min(1e-30)
    return (acc / denom[..., None]).transpose(1, 2), m + torch.log(denom)


def f32_rounding() -> None:
    """Where the f32 tensor-core kernels' error against their plain versions
    comes from: at B = 8, N = 908 fully connected (a train step's, the worst
    case: every key in every sum), H = 8 and a tp rank's 4, Dh 32 and 144,
    the kernels' outputs beside emulations of their arithmetic in f64 on the
    card (the same TF32 halves and m16n8k8 steps in the same order): the
    forward's O (``_emulate_f32_fwd``), whose products reach the f32
    accumulator rounded to nearest (rn) or toward zero (rz) at each product,
    or toward zero within a step and to nearest across steps (rz3+rn), or as
    the kernel sums them, each key tile's P·V toward zero and the tiles to
    nearest (tile); and the pair's dQ, dK and dV (``_emulate_f32_pair``: rn,
    rz, rz3+rn). For each output: the worst error over the f32 gate's
    tolerance (the forward's 1e-5 relative plus 1e-5 of max|v|, the pair's
    1e-5 relative plus 1e-5 of max|ref|, ref the plain version) of the kernel
    and of each emulation, and the largest |kernel − emulation| over the same
    tolerance; and the kernels' times (CUDA events, as the timing phase takes
    them)."""
    import torch

    from diffassemble_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator(device="cuda").manual_seed(9)
    for heads in (HEADS // TP, HEADS):
        for dh in MAIN_HEAD_DIMS:
            mask = torch.ones((TRAIN_BATCH, N_NODES, N_NODES), dtype=torch.bool, device="cuda")
            q, k, v, dout = (torch.randn((TRAIN_BATCH, N_NODES, heads, dh), generator=gen, device="cuda")
                             for _ in range(4))
            if ca.route("masked_attention_fwd", q, k, v, mask) != "tensor_cores":
                raise AssertionError(f"f32 forward off the tensor cores at H={heads} Dh={dh}")
            o, lse = ca.masked_attention_fwd(q, k, v, mask)
            o_p = ca.masked_attention_fwd_plain(q, k, v, mask)[0]
            phase(f"f32 rounding: B={TRAIN_BATCH} N={N_NODES} H={heads} Dh={dh} kernel forward "
                  f"{cuda_ms(lambda: ca.masked_attention_fwd(q, k, v, mask)):.4f} ms")
            tol = 1e-5 * o_p.abs() + 1e-5 * v.abs().max()
            emus = {}
            for model in ("rn", "rz", "rz3+rn", "tile"):
                emus[model], _ = _emulate_f32_fwd(q, k, v, mask, model)
            worst = {"kernel": ((o - o_p).abs() / tol).max().item()}
            worst.update({m: ((e - o_p).abs() / tol).max().item() for m, e in emus.items()})
            apart = {m: ((o - e).abs() / tol).max().item() for m, e in emus.items()}
            equal = {m: (o == e).float().mean().item() for m, e in emus.items()}
            phase(f"f32 rounding: O H={heads} Dh={dh:3d} worst err/tol against the plain version "
                  f"{ {m: round(x, 4) for m, x in worst.items()} }; kernel apart from each emulation, "
                  f"max |kernel - emulation|/tol {({m: round(x, 4) for m, x in apart.items()})}, share "
                  f"bit-equal {({m: round(x, 4) for m, x in equal.items()})}")
            del emus, o_p, tol
            args = (q, k, v, mask, dout, lse, ca.attention_delta(dout, o))
            if {ca.route(name, *args) for name in ca.BACKWARD_PAIR} != {"tensor_cores"}:
                raise AssertionError(f"f32 pair off the tensor cores at H={heads} Dh={dh}")
            got = (ca.masked_attention_bwd_dq(*args), *ca.masked_attention_bwd_dkv(*args))
            refs = (ca.masked_attention_bwd_dq_plain(*args), *ca.masked_attention_bwd_dkv_plain(*args))
            phase(f"f32 rounding: B={TRAIN_BATCH} N={N_NODES} H={heads} Dh={dh} kernels dQ "
                  f"{cuda_ms(lambda: ca.masked_attention_bwd_dq(*args)):.4f} ms, dK/dV "
                  f"{cuda_ms(lambda: ca.masked_attention_bwd_dkv(*args)):.4f} ms")
            tols = [1e-5 * r.abs() + 1e-5 * r.abs().max() for r in refs]
            emus = {}
            for model in ("rn", "rz", "rz3+rn"):
                start = time.perf_counter()
                emus[model] = _emulate_f32_pair(*args, model)
                torch.cuda.synchronize()
                phase(f"f32 rounding: emulated {model} at B={TRAIN_BATCH} N={N_NODES} H={heads} Dh={dh} in "
                      f"{time.perf_counter() - start:.1f} s")
            for i, key in enumerate(("dQ", "dK", "dV")):
                worst = {"kernel": ((got[i] - refs[i]).abs() / tols[i]).max().item()}
                worst.update({m: ((e[i] - refs[i]).abs() / tols[i]).max().item() for m, e in emus.items()})
                apart = {m: ((got[i] - e[i]).abs() / tols[i]).max().item() for m, e in emus.items()}
                equal = {m: (got[i] == e[i]).float().mean().item() for m, e in emus.items()}
                phase(f"f32 rounding: {key} H={heads} Dh={dh:3d} worst err/tol against the plain version "
                      f"{ {m: round(x, 4) for m, x in worst.items()} }; kernel apart from each emulation, "
                      f"max |kernel - emulation|/tol {({m: round(x, 4) for m, x in apart.items()})}, share "
                      f"bit-equal {({m: round(x, 4) for m, x in equal.items()})}")
            del emus, got, refs, tols
            torch.cuda.empty_cache()


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


# ------------------------------------------------------------------ phases 17-21: the rest of the 2D and 3D family


def _train_argv(run_dir: Path, *flags: str) -> list[str]:
    """The flagship's training flags (``TRAIN_FLAGS``) with ``flags`` after them, in ``run_dir``."""
    return [*TRAIN_FLAGS, *flags, "--run_dir", str(run_dir)]


def _seeded_loss_2d(label: str, missing_perc: int = 0, **cfg_changes) -> dict[str, float]:
    """``card_vs_cpu_loss_2d`` of the flagship's config in f32 with
    ``cfg_changes`` and seeded weights (then, with ``visual_pretrained``,
    the features npz loaded by ``init``), on two 6×6 puzzles over the 60%
    expander, each without ``missing_perc``% of its pieces, with numpy draws
    of t and the noise."""
    import dataclasses

    import numpy as np

    from diffassemble_tpu_torch.models import Diffusion2D

    cfg = dataclasses.replace(flagship_config(), compute_dtype="float32", encoder_init="", **cfg_changes)
    rng = np.random.default_rng(LOSS3D_SEED)
    host = seeded_puzzles(6, 2, cfg.rotation, rng, degree="60%", missing_perc=missing_perc)
    valid = host.node_mask.sum(axis=1).tolist()
    if valid != [36 - math.ceil(36 * missing_perc / 100)] * 2:
        raise AssertionError(f"{label}: valid pieces per puzzle {valid}")
    draws = {"t_graph": rng.integers(0, cfg.steps, 2), "noise": rng.standard_normal(host.x0.shape, dtype=np.float32)}

    def make_model(device):
        model = Diffusion2D(cfg, device=device, seed=0)
        if cfg.visual_pretrained:
            model.init(0)
        return model

    return card_vs_cpu_loss_2d(make_model, host, draws, f"{label} ({valid[0]} valid pieces of 36)")


def _run_2d_phase(label: str, argvs: list[list[str]], launches: int, cli=None) -> tuple[dict, dict, dict]:
    """``drive_trainer`` over ``argvs`` with the counts from 0: every step
    ``launches`` of each kernel on the tensor cores, finite, with gradients;
    each run's sanity evaluation 120 forward launches (none with
    ``launches`` 0). Returns (launches, by route, the result: s/step by host
    clock and CUDA events, peak memory, losses, steps)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    steps, runs = drive_trainer(argvs, label, cli)
    seconds = time.perf_counter() - start
    counts, routes = read_counts(), read_routes()
    peak = torch.cuda.max_memory_allocated()
    _check_trainer_steps(steps, label, launches)
    in_steps = {k: sum(s["launches"][k] for s in steps) for k in WRAPPERS}
    sanity = {k: counts[k] - in_steps[k] for k in WRAPPERS}
    per_call = 4 * 30 if launches else 0  # 4 layers × 30 DDIM steps a sanity call
    if sanity != launches_of(fwd=len(argvs) * per_call) or any(r["cuda_cores"] for r in by_route(routes).values()):
        raise AssertionError(f"{label}: sanity evaluations launched {sanity}, by route {routes}")
    steady = [s for i, s in enumerate(steps) if i not in (0, runs[0])] or steps[1:]
    result = {"seconds": seconds, "runs": runs, "max_memory_allocated": peak,
              "losses": [s["total_loss"] for s in steps], "host_s": [s["seconds"] for s in steps],
              "cuda_ms": [s["ms"] for s in steps], "steady_host_s": [s["seconds"] for s in steady],
              "steady_cuda_ms": [s["ms"] for s in steady], "steps": steps}
    return counts, routes, result


def _beside_phase_6(label: str, result: dict, baseline: dict) -> None:
    phase(f"{label}: steady s/step by host clock {_spread(result['steady_host_s'])}, CUDA events "
          f"{_spread(result['steady_cuda_ms'])} ms, max_memory_allocated {result['max_memory_allocated'] / 2**30:.2f} "
          f"GiB | efficientnet_b0 (phase 6): {_spread(baseline['host_s'])} s, {_spread(baseline['cuda_ms'])} ms, "
          f"{baseline['max_memory_allocated'] / 2**30:.2f} GiB")


def light_2d(workdir: Path, baseline: dict) -> dict[str, tuple]:
    """Phase 17, the fifteenth and sixteenth main paths: ``run_2d`` of the
    rotation CLI at the flagship's widths (``TRAIN_FLAGS``: 30×30 over the
    10% expander, exophormer, bf16, batch 8) from seeded weights with the
    light encoders ``convnet`` and ``tiny``: 2 steps, a checkpoint, a resume
    to 3, each step 4 + 4 + 4 tensor-core launches; and with the ``gcn``
    backbone (efficientnet_b0) for 2 steps, with no attention launch at all.
    Each first holds its seeded f32 loss on the card to the CPU's. Returns,
    by name, (launches, by route, the result)."""
    out = {}
    for name, flags, launches in (("convnet", ["--backbone", "convnet"], 4), ("tiny", ["--backbone", "tiny"], 4),
                                  ("gcn", ["--architecture", "gcn"], 0)):
        change = {flags[0][2:]: flags[1]}
        loss = _seeded_loss_2d(f"{name} loss", **change)
        argv = _train_argv(workdir / name, *flags)
        argvs = [argv + ["-max_steps", str(LIGHT_STEPS)]]
        if launches:
            argvs.append(argv + ["-max_steps", str(LIGHT_RESUME_TO)])
        counts, routes, result = _run_2d_phase(name, argvs, launches)
        if launches == 0 and any(counts.values()):
            raise AssertionError(f"gcn launched attention kernels: {counts}")
        want = list(range(1, (LIGHT_RESUME_TO if launches else LIGHT_STEPS) + 1))
        if [s["step"] for s in result["steps"]] != want:
            raise AssertionError(f"{name}: steps {[s['step'] for s in result['steps']]}, expected {want}")
        saved = json.loads((workdir / name / "checkpoints" / "config.json").read_text())
        if saved[flags[0][2:]] != flags[1]:
            raise AssertionError(f"{name}: config {saved}")
        result["loss_f32_card"] = loss
        _beside_phase_6(f"{name} training ({len(result['steps'])} steps, launches {counts})", result, baseline)
        out[name] = (counts, routes, result)
    return out


def pretrained_features(workdir: Path, baseline: dict) -> tuple[dict, dict, dict]:
    """Phase 18, the seventeenth main path: ``visual_pretrained`` from a
    features npz in the layout of a converted timm file (the encoder subtree
    of ``weights/efficientnet_b0_pose30hf.npz``, keys without ``encoder/``).
    The model's ``init`` loads it: the encoder equals the file; with the
    BatchNorms folded affine a patch's features are the same, within bf16
    rounding (1/64 of the largest feature), in batches of 4 and of 16. Its
    seeded f32 loss on the card is held to the CPU's. Then
    ``train_2d_rot --visual_pretrained true`` for 2 steps (4 + 4 + 4
    tensor-core launches each)."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch import convert
    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.utils.params import load_params

    npz = workdir / "efficientnet_b0_features.npz"
    with np.load(ENCODER_INIT) as z:
        np.savez(npz, **{k[len("encoder/"):]: z[k] for k in z.files if k.startswith("encoder/")})
    cfg = dataclasses.replace(flagship_config(), encoder_init="", visual_pretrained=True, visual_weights=str(npz))
    model = Diffusion2D(cfg, device="cuda", seed=3)
    model.init(0)
    want = convert.convert_params({"encoder": load_params(npz)})
    got = model.encoder.state_dict()
    if got.keys() != {k[len("encoder."):] for k in want} or \
            not all(torch.equal(v.cpu(), want[f"encoder.{k}"]) for k, v in got.items()):
        raise AssertionError("the pretrained encoder differs from its file after init")
    patches = torch.as_tensor(np.random.default_rng(5).random((16, 32, 32, 3), dtype=np.float32), device="cuda")
    with torch.no_grad():
        f16, f4 = model.encoder(patches).float(), model.encoder(patches[:4]).float()
    err, scale = (f16[:4] - f4).abs().max().item(), f16.abs().max().item()
    if not (math.isfinite(err) and err <= scale / 64):
        raise AssertionError(f"pretrained features depend on the batch: max|d| {err} of {scale}")
    phase(f"pretrained features: the encoder equals {npz.name} after init ({len(got)} tensors); a patch's bf16 "
          f"features in batches of 4 and 16: max|d| {err:.3e} of max {scale:.3e} (gate 1/64 of it)")
    del model
    loss = _seeded_loss_2d("pretrained loss", visual_pretrained=True, visual_weights=str(npz))
    argv = _train_argv(workdir / "pretrained", "--visual_pretrained", "true", "--visual_weights", str(npz))
    counts, routes, result = _run_2d_phase("pretrained", [argv + ["-max_steps", str(LIGHT_STEPS)]], 4)
    result.update(batch_4_vs_16_max_abs=err, loss_f32_card=loss)
    _beside_phase_6(f"pretrained training ({len(result['steps'])} steps, launches {counts})", result, baseline)
    return counts, routes, result


def missing_pieces(workdir: Path) -> tuple[dict, dict, dict]:
    """Phase 19, the eighteenth main path: ``cli/train_2d_missing.py`` at its
    default ``--missing 20`` with the flagship's flags (rotation, x₀, the
    exophormer with 8 virtual nodes) for 2 steps after its sanity
    evaluation: every puzzle of every step has 720 valid pieces of 900.
    First its seeded f32 loss on 6×6 puzzles with 28 valid pieces of 36 (the
    other 8 padded and masked out) is held on the card to the CPU's."""
    from diffassemble_tpu_torch.cli import train_2d_missing

    loss = _seeded_loss_2d("missing loss", missing_perc=MISSING_PERC)
    argv = _train_argv(workdir / "missing", "--rotation", "true", "--predict_xstart", "true", "--architecture",
                       "exophormer", "--virt_nodes", "8", "-max_steps", str(LIGHT_STEPS))
    counts, routes, result = _run_2d_phase("missing", [argv], 4, train_2d_missing)
    valid = sorted({v for s in result["steps"] for v in s["valid"]})
    if valid != [900 - math.ceil(900 * MISSING_PERC / 100)]:
        raise AssertionError(f"missing pieces: valid pieces per puzzle {valid}")
    metrics = [json.loads(line) for line in (workdir / "missing" / "metrics.jsonl").read_text().splitlines()]
    sanity = [m["sanity/overall__piece_acc"] for m in metrics if "sanity/overall__piece_acc" in m]
    result.update(valid_pieces=valid, sanity_piece_acc=sanity, loss_f32_card=loss)
    phase(f"missing pieces: {len(result['steps'])} steps of puzzles with {valid} valid pieces of 900, launches "
          f"{counts}, sanity piece_acc {sanity}, steady s/step {_spread(result['steady_host_s'])}")
    return counts, routes, result


def _port_run_2d(run_dir: Path, model, cfg, step: int, device: str = "cuda") -> None:
    """A trained 2D model written as a run of the port for ``device``: config.json and a checkpoint at ``step``."""
    import torch

    from diffassemble_tpu_torch.train.checkpoint import CheckpointManager
    from diffassemble_tpu_torch.train.train_state import TrainState

    ckpt = CheckpointManager(run_dir / "checkpoints")
    ckpt.save_config(cfg)
    ckpt.save(step, TrainState(dict(model.named_parameters()), {}, step, torch.Generator(device=device).manual_seed(0)))


def _evaluate_again(model, sizes: list[int], batch_size: int, calibrate: int = 0, **knobs):
    """What ``cli/evaluate.py`` computes for its first batch at seed 0, built
    anew from ``model`` (the asset's weights, loaded without the run's
    checkpoint): the ``get_dataset`` test batch of ``sizes`` with the image
    ``knobs``, OrientationNorm statistics calibrated over ``calibrate``
    training batches, the sample from a card generator seeded 0. Returns
    (the final poses on the host, the statistics or None)."""
    import numpy as np
    import torch

    from diffassemble_tpu_torch.data import PuzzleBatch, collate_puzzles
    from diffassemble_tpu_torch.data.datasets import get_dataset

    train_ds, test_ds, _ = get_dataset("synthetic", puzzle_sizes=sizes, rotation=model.cfg.rotation, seed=0, **knobs)
    stats = None
    if calibrate:
        calib = []
        for bi in range(calibrate):
            nb = collate_puzzles([train_ds[i % len(train_ds)] for i in range(bi * batch_size, (bi + 1) * batch_size)],
                                 train_ds.max_nodes)
            calib.append((nb.patches.astype(np.float32) / 255.0).reshape(-1, *nb.patches.shape[2:]))
        stats = model.calibrate_norm_stats(calib)
    batch = PuzzleBatch(*collate_puzzles([test_ds[i] for i in range(batch_size)], test_ds.max_nodes)).to("cuda")
    with torch.no_grad():
        final = model.sample(batch, torch.Generator(device="cuda").manual_seed(0)).final
    return final.cpu(), stats


def evaluate_cli(workdir: Path) -> dict[str, tuple]:
    """Phase 20, the nineteenth main path: ``cli/evaluate.py`` on trained
    checkpoints written as runs of the port, one batch of 4 each, 120 forward
    launches a call, all on the tensor cores. Every call's first sample is
    held bit for bit to ``_evaluate_again`` on the asset's weights loaded
    apart from the run, so that a wrong checkpoint load, parameter or
    statistic fails.

    - The flagship (the EMA of ``weights/diffusion2d_rot30`` at step 32000),
      30×30, no images: on ``get_dataset``'s default images (canonical 0.5,
      no fine detail, as the JAX CLI makes them), ungated beyond the
      reproduction; then on its recipe's (canonical 0.8, hf_detail 0.25,
      ``data.json``), where its piece_acc must reach EVAL_CLI_MIN_ACC.
    - ``diffusion2d_rot_ms`` (step 7000), 6×6: OrientationNorm statistics
      calibrated over 2 training batches, written as ``norm_stats.npz`` and
      equal to those calibrated apart; every step's reconstruction saved
      (``.npy`` where PIL is missing): 120 files. Ungated beyond these: a
      batch of 6×6 puzzles alone normalises over other patches than the
      training batches, padded to 144 nodes. Then at its protocol's sizes
      (6, 8, 10, 12: padded to 144 as in training) with batch statistics,
      where its piece_acc must reach EVAL_CLI_MIN_ACC and lie within
      PIECE_ACC_TOL of the same CLI's on this host's CPU (f32).

    Returns, by call, (launches, by route, the result)."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch import convert
    from diffassemble_tpu_torch.cli import evaluate
    from diffassemble_tpu_torch.data import datasets
    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.nn.visual import norm_layers, save_norm_stats
    from diffassemble_tpu_torch.train.heldout import asset_protocol, load_asset

    state, _ = convert.load_jax_npz(ASSET)
    cfg = dataclasses.replace(flagship_config(), encoder_init="")
    rot30 = Diffusion2D(cfg, device="cuda")
    rot30.load_state_dict(state, strict=True)
    _port_run_2d(workdir / "eval_rot30", rot30, cfg, 32000)
    rot_ms, ms_cfg, _, _ = load_asset("diffusion2d_rot_ms", "cuda")
    _port_run_2d(workdir / "eval_rot_ms", rot_ms, ms_cfg, 7000)
    n_norms = len(norm_layers(rot_ms.encoder))
    for m in (rot30, rot_ms):
        m.eval()
    recipe = json.loads(DATA.read_text())
    knobs = {"canonical": recipe["canonical"], "hf_detail": recipe["hf_detail"]}
    ms_sizes = asset_protocol("diffusion2d_rot_ms")[0]["hw"]
    calls = (  # (name, run, puzzle sizes, calibration batches, save images, image knobs)
        ("rot30", "eval_rot30", [30], 0, False, {}),
        ("rot30_recipe_images", "eval_rot30", [30], 0, False, knobs),
        ("rot_ms", "eval_rot_ms", [6], 2, True, {}),
        ("rot_ms_protocol_sizes", "eval_rot_ms", ms_sizes, 0, False, {}),
    )
    get_dataset = datasets.get_dataset
    sample = Diffusion2D.sample
    out = {}
    for name, run, sizes, calibrate, images, knob in calls:
        run_dir = workdir / run
        finals = []

        def spy(self, *args, **kwargs):
            res = sample(self, *args, **kwargs)
            finals.append(res.final.cpu())
            return res

        argv = ["--run_dir", str(run_dir), "--puzzle_sizes", *map(str, sizes), "--calibrate_norm", str(calibrate),
                "--save_images", str(images).lower(), "--out_dir", str(workdir / f"preds_{name}"), "--batch_size", "4",
                "--n_batches", "1"]
        for f in run_dir.glob("norm_stats.npz"):
            f.unlink()
        torch.cuda.synchronize()
        reset_counts()
        start = time.perf_counter()
        with mock.patch.object(Diffusion2D, "sample", spy), \
                mock.patch.object(datasets, "get_dataset", lambda *a, **k: get_dataset(*a, **{**k, **knob})):
            metrics = evaluate.main([*argv, "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        counts, routes = read_counts(), read_routes()
        piece_acc = metrics[0]["piece_acc"]
        if counts != launches_of(fwd=120) \
                or routes["masked_attention_fwd"]["cuda_cores"] or len(finals) != 1 or not math.isfinite(piece_acc):
            raise AssertionError(f"evaluate {name}: launches {counts}, by route {routes}, metrics {metrics}")
        model = rot30 if run == "eval_rot30" else rot_ms
        again, stats = _evaluate_again(model, sizes, 4, calibrate, **knob)
        model.norm_stats = None
        if not torch.equal(finals[0], again):
            raise AssertionError(f"evaluate {name}: the CLI's sample differs from the asset's own by "
                                 f"{(finals[0] - again).abs().max().item()}")
        preds = workdir / f"preds_{name}"
        files = sorted(p.name for p in preds.iterdir()) if preds.exists() else []
        result = {"metrics": metrics, "seconds": seconds, "files": len(files), "reproduced": True}
        note = ""
        if calibrate:
            save_norm_stats(workdir / "norm_stats_again.npz", stats)
            with np.load(run_dir / "norm_stats.npz") as z, np.load(workdir / "norm_stats_again.npz") as w:
                if len(z.files) != 2 * n_norms or sorted(z.files) != sorted(w.files) or \
                        not all(np.array_equal(z[k], w[k]) for k in z.files):
                    raise AssertionError(f"evaluate {name}: norm_stats.npz ({len(z.files)} arrays for {n_norms} "
                                         f"layers) differs from the statistics calibrated apart")
            if len(files) != 4 * 30 or not all(f.endswith((".png", ".png.npy")) for f in files):
                raise AssertionError(f"evaluate {name}: {len(files)} images, expected 120: {files[:3]}")
            result["norm_stats_arrays"] = 2 * n_norms
            note = f", {len(files)} images ({files[0].split('.', 1)[1]}), norm_stats.npz equal to a calibration apart"
        elif files and not images:
            raise AssertionError(f"evaluate {name} saved images: {files[:3]}")
        if name in ("rot30_recipe_images", "rot_ms_protocol_sizes") and not piece_acc >= EVAL_CLI_MIN_ACC:
            raise AssertionError(f"evaluate {name}: piece_acc {piece_acc} below {EVAL_CLI_MIN_ACC}")
        if name == "rot_ms_protocol_sizes":
            cpu_run = workdir / "eval_rot_ms_cpu"
            cpu_cfg = dataclasses.replace(ms_cfg, compute_dtype="float32")
            cpu_model = type(rot_ms)(cpu_cfg, device="cpu")
            cpu_model.load_state_dict({k: v.cpu() for k, v in rot_ms.state_dict().items()})
            _port_run_2d(cpu_run, cpu_model, cpu_cfg, 7000, device="cpu")
            host = time.perf_counter()
            cpu = evaluate.main(["--run_dir", str(cpu_run), *argv[2:], "--device", "cpu"])[0]["piece_acc"]
            result.update(cpu_piece_acc=cpu, cpu_seconds=time.perf_counter() - host)
            if not abs(piece_acc - cpu) <= PIECE_ACC_TOL:
                raise AssertionError(f"evaluate {name}: piece_acc {piece_acc} on the card, {cpu} on the CPU (f32)")
            note = f", the CPU's (f32) {cpu!r} in {result['cpu_seconds']:.1f} s"
        phase(f"evaluate {name}: {seconds:.2f} s, piece_acc {[m['piece_acc'] for m in metrics]}, launches {counts} "
              f"(forward by route {routes['masked_attention_fwd']}), the sample bit-equal to the asset's own{note}")
        out[f"evaluate_{name}"] = (counts, routes, result)
    return out


def export_meshes_3d(workdir: Path) -> tuple[dict, dict, dict]:
    """Phase 21a, the twentieth main path: ``run_3d --evaluate
    --export_meshes`` on the trained ``diffusion3d_easy`` (step 12000)
    written as a run of the port, its protocol cut to 4 objects in one call:
    the trajectories of the 4 objects (30 ``.ply`` and one ``_traj.npz``
    each), then the evaluation; 120 forward launches each, 90 on the tensor
    cores (Dh 32) and 30 on the small-graph route (Dh 264). The trajectory's last
    step is, bit for bit, a ``sample`` of the same objects without a
    trajectory on a generator seeded as the export's."""
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch.cli import train_3d
    from diffassemble_tpu_torch.data.breaking_bad import collate_fragments
    from diffassemble_tpu_torch.train.heldout3d import model_from_asset

    model, cfg, protocol, step = model_from_asset(ASSET_3D, "cuda")
    run_dir = workdir / "export3d"
    cli, seconds, counts, routes = cli_evaluate_3d(run_dir, model, cfg, step, {**protocol, "test_n": 4, "batch": 4},
                                                   "--export_meshes")
    meshes = run_dir / "meshes"
    ply = sorted(meshes.glob("*.ply"))
    npz = sorted(meshes.glob("*_traj.npz"))
    if len(ply) != 4 * 30 or len(npz) != 4:
        raise AssertionError(f"export_meshes: {len(ply)} .ply and {len(npz)} _traj.npz files")
    reverse = cfg.steps // cfg.inference_ratio
    want = on_routes(tensor_cores=2 * (cfg.n_layers - 1) * reverse, small_graph=2 * reverse)
    if counts != launches_of(fwd=2 * 120) or routes["masked_attention_fwd"] != want:
        raise AssertionError(f"export_meshes: launches {counts}, forward by route {routes['masked_attention_fwd']}; "
                             f"expected {want}")
    ap = train_3d.argparse.ArgumentParser()
    train_3d.add_3d_args(ap)
    args = ap.parse_args(["--dataset", "synthetic", "--test_n", "4", "--num_points", str(protocol["num_points"]),
                          "--max_num_part", str(protocol["max_num_part"]), "--min_num_part",
                          str(protocol["min_num_part"]), "--wall_detail", str(protocol["wall_detail"]),
                          "--wall_boost", str(protocol["wall_boost"]), "--synthetic_canonical",
                          str(protocol["canonical"]), "--seed", str(protocol["seed"])])
    _, test_ds, _ = train_3d.datasets_3d(args)
    nb = collate_fragments([test_ds[i] for i in range(4)], protocol["max_num_part"])
    final = model.sample(nb.to("cuda"), torch.Generator(device="cuda").manual_seed(1)).final.cpu().numpy()
    for b, path in enumerate(npz):
        with np.load(path) as z:
            if not np.array_equal(z["trajectory"][-1], final[b]):
                raise AssertionError(f"{path.name}: the trajectory's last step differs from the sample")
    result = {"seconds": seconds, "ply": len(ply), "traj_npz": len(npz),
              "ply_bytes": sum(p.stat().st_size for p in ply), "metrics": {k: v[0] for k, v in cli.items()}}
    phase(f"export_meshes: {len(ply)} .ply ({result['ply_bytes'] / 2**20:.1f} MiB) and {len(npz)} _traj.npz in "
          f"{seconds:.2f} s with the evaluation of 4 objects; launches {counts}, forward by route "
          f"{routes['masked_attention_fwd']}; each trajectory's last step "
          f"bit-equal to a sample without one")
    del model
    return counts, routes, result


def ddp_world_of_one_3d() -> tuple[dict, dict]:
    """Phase 21b, the twenty-first main path: one ``Trainer`` step of the 3D
    model with the easy run's flags (``TRAIN3D_FLAGS``: vn_dgcnn_rich from
    its encoder_init, batch 16, the relative-pose losses) on the run's first
    batch without a process group, under DDP in a world of one over NCCL,
    and without again: parameters and gradients bit-equal. Each step 8
    forward launches (6 on the tensor cores, 2 on the small-graph route), 6 dQ and
    6 dK/dV launches on the tensor cores and 2 fused backward launches on
    the small-graph route (``step_routes_3d``). A second card would let 2
    NCCL ranks run against one process; one card does not."""
    import torch

    from diffassemble_tpu_torch.cli import train_3d
    from diffassemble_tpu_torch.models import Diffusion3D
    from diffassemble_tpu_torch.parallel.dryrun import one_rank_ddp_matches

    args = train3d_args("")
    batch = loss_inputs_3d(args)[0].to("cuda")
    reset_counts()
    n = one_rank_ddp_matches(lambda: Diffusion3D(train_3d.config_from_args(args), device="cuda", seed=0), batch,
                             "nccl")
    counts, routes = read_counts(), read_routes()
    step = step_routes_3d(2, train_3d.config_from_args(args).n_layers)
    if by_route(routes) != {k: {r: 3 * n for r, n in per.items()} for k, per in step.items()}:
        raise AssertionError(f"3D ddp: launches {counts} by route {routes}, expected {step} in each of 3 steps")
    phase(f"3D ddp: a world of one over NCCL, one Trainer step bit-equal to the plain step ({n} parameters and "
          f"their gradients; a second plain step equal too); launches {counts}; 2 NCCL ranks against one process: "
          f"not run (this smoke drives one card; the machine has {torch.cuda.device_count()})")
    return counts, routes


def rest_of_the_family(baseline: dict) -> dict[str, tuple]:
    """Phases 17-21 by path: (launches, by route[, the result])."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rest_") as tmp:
        rest = light_2d(Path(tmp), baseline)
        rest["pretrained"] = pretrained_features(Path(tmp), baseline)
        rest["missing"] = missing_pieces(Path(tmp))
        rest.update(evaluate_cli(Path(tmp)))
        rest["export_meshes_3d"] = export_meshes_3d(Path(tmp))
    rest["ddp_3d"] = ddp_world_of_one_3d()
    return rest


# phase 22: tensor parallelism on one card. Its ranks are processes on the one H100 in a gloo group over
# CUDA tensors (NCCL refuses two ranks on one device), spawned after the parent built the kernels, so
# that they load the built libraries. Each step is held twice: its loss, gradient norms and gradients
# against the single-process step, and its update against the single-process optimizer replayed on its
# own whole gradients (hold_update). Tolerances (PERF.md §6 gives the readings): the f32 2D steps as
# the gloo dryrun holds them (parallel/dryrun.py GRAD_TOL: TP only reorders sums), their updates too
TP = 2
# bf16 steps against the bf16 step (rel, atol, norm_rel, loss_rel), set from the phase's readings on an
# H100 at 700 W (PERF.md §6): at (0.02, 1e-3, 1e-3, 1e-3) the tp = 2 step read worst err/tol 0.464 in
# its gradients (tensors whose largest entry is below the atol term) and 0.049 in its loss and norms.
# The phase prints bf16's own distance, the one-process bf16 step's from the f32 step's, under them
TP_BF16_TOL = (0.02, 2e-3, 1e-3, 1e-3)
# a request's final positions, absolute on the [-1, 1] grid: a third of the 30x30 grid's spacing 2/29
TP_REQUEST_TOL = 0.02
TP_PIECE_ACC_TOL = 0.005  # the held-out call's piece_acc under tp against one process
TP_JOIN_S = 600  # a phase whose ranks take longer is taken to hang: they are killed and the phase fails
# the dp x tp 3D step's gradients within this of each tensor's largest entry (GRAD_TOL["3d"] otherwise):
# twice what one ulp up or down on every parameter moved the same step's gradients by in one process on
# the card, 2.467e-3 to 2.474e-3 in four runs. Its VN-DGCNN encoder picks 20 neighbours in feature space
# for each of 65,536 points, and rounding flips near-ties
DPTP_3D_GRAD_REL = 5e-3
DPTP_BATCH_3D = 16  # the 3D recipe's batch (TRAIN3D_FLAGS), 8 objects a dp place
# a replayed update against the rank's: each parameter within this many f32 ulps of it and of its update
# (the same arithmetic on the same whole tensors; a reduction in another order moves Adafactor's scales
# by an ulp); a slice put back in the wrong place moves whole rows by their full size
UPDATE_ULPS = 4


class _TimedCollectives:
    """Stands in for ``torch.distributed`` inside ``parallel/tensor.py``: its
    all-reduces (every tp collective is one) timed by the host clock between
    two synchronizes."""

    def __init__(self):
        self.seconds, self.calls, self.bytes = 0.0, 0, 0

    def all_reduce(self, t, group=None):
        import torch
        import torch.distributed as dist

        torch.cuda.synchronize()
        start = time.perf_counter()
        dist.all_reduce(t, group=group)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - start
        self.calls += 1
        self.bytes += t.numel() * t.element_size()


def _timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its device time by CUDA events and its host time."""
    import torch

    torch.cuda.synchronize()
    host = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn(*args, **kwargs)
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1]), time.perf_counter() - host


def _step_record(tr, state, batch, during=None) -> tuple:
    """One ``Trainer`` step from ``state`` on ``batch`` (this rank's dp slice),
    as ``dryrun.compare_steps`` reads it (whole parameters and gradients, on
    the host), with its launches, routes and times; ``during`` is a context
    entered around the step alone."""
    from diffassemble_tpu_torch.parallel.mesh import gather_params

    before = {k: v.cpu() for k, v in gather_params(tr.model).items()}
    reset_counts()
    with during or contextlib.nullcontext():
        (state, aux), ms, host_s = _timed(tr.train_step, state, batch)
    rec = {"aux": {k: float(v) for k, v in aux.items()}, "before": before,
           "params": {k: v.cpu() for k, v in gather_params(tr.model).items()},
           "grads": {k: v.cpu() for k, v in
                     gather_params(tr.model, {k: p.grad for k, p in state.params.items()}).items()},
           "unfactored": sorted(state.opt_state["v"]), "launches": read_counts(), "routes": read_routes(),
           "ms": ms, "host_s": host_s}
    if not tr.mesh.distributed:  # the single process's optimizer, to replay the ranks' updates with
        rec["optimizer"] = tr.optimizer
    return state, rec


def hold_update(label: str, rec: dict, optimizer) -> float:
    """A rank's update (``_step_record``: its whole parameters before and
    after the step) against the single-process ``optimizer``'s first update
    from the same whole parameters on the rank's whole clipped gradients,
    replayed on the card: each parameter within ``UPDATE_ULPS`` f32 ulps of
    it and of its update.
    With its gradients held to the single process's, this holds the rank's
    whole step: the gathering, the optimizer on whole tensors and each
    rank's slice of the update. Returns the largest |difference|."""
    import torch

    before = {k: v.cuda() for k, v in rec["before"].items()}
    updates, _ = optimizer.update({k: v.cuda() for k, v in rec["grads"].items()}, optimizer.init(before), before)
    worst = 0.0
    for k, u in updates.items():
        want, u = (before[k] + u).cpu(), u.cpu()
        err = (rec["params"][k] - want).abs()
        worst = max(worst, float(err.max()))
        if not bool((err <= UPDATE_ULPS * torch.finfo(want.dtype).eps * (want.abs() + u.abs())).all()):
            raise AssertionError(f"{label}: {k} differs from the single-process optimizer's update on the rank's "
                                 f"gradients by up to {float(err.max()):.3e}")
    return worst


def update_readings(rec: dict, ref: dict, rel: float) -> list[tuple]:
    """Where a rank's update differs from the single process's by more than
    ``compare_steps`` would allow (``rel`` of the tensor's largest move plus
    1e-6 of each parameter): (err / tol, name, the single process's largest
    gradient entry, the rank's largest gradient difference from it), worst
    first. A reading only: Adafactor's first update divides each gradient by
    its row's and column's RMS (each entry's own, where unfactored), so a
    gradient whose size is its rounding noise moves at full size."""
    out = []
    for k, g in ref["grads"].items():
        d_want, d_got = ref["params"][k] - ref["before"][k], rec["params"][k] - rec["before"][k]
        tol = rel * float(d_want.abs().max()) + 1e-6 * ref["params"][k].abs()
        ratio = float(((d_got - d_want).abs() / tol).max())
        if ratio > 1:
            out.append((ratio, k, float(g.abs().max()), float((rec["grads"][k] - g).abs().max())))
    return sorted(out, reverse=True)


def _flagship_trainer(mesh, workdir: Path, dtype: str, label: str):
    """A ``Trainer`` of the flagship (its encoder_init, ``dtype``, no warmup:
    with the flagship's 500 steps the first update is exactly 0, and the
    step would not show the optimizer) on ``mesh`` at batch 8, its state made
    (and the model sharded), and the phase's batch: 8 seeded 30×30 puzzles
    over the 10% expander, as the parent wrote it; this rank's dp slice of
    it."""
    import dataclasses

    import torch

    from diffassemble_tpu_torch.data import PuzzleBatch
    from diffassemble_tpu_torch.models import Diffusion2D
    from diffassemble_tpu_torch.parallel.mesh import shard_batch
    from diffassemble_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(flagship_config(), encoder_init=str(ENCODER_INIT), compute_dtype=dtype,
                              warmup_steps=0)
    tr = Trainer(Diffusion2D(cfg, device="cuda", seed=0), run_dir=str(workdir / f"{label}_{mesh.rank}"),
                 batch_size=TRAIN_BATCH, mesh=mesh, viz_every_eval=0)
    state = tr.new_state()
    batch = PuzzleBatch(*torch.load(workdir / "tp_batch.pt", weights_only=True)).to("cuda")
    return tr, state, shard_batch(mesh, batch)


def tp_flagship(mesh, workdir: Path) -> dict:
    """Phase 22a-c on one rank of ``mesh`` (or, on ``Mesh()``, the single
    process that each is held to): (a) a Trainer step of the flagship in
    f32, then in bf16 followed by a steady step and one with the tp
    collectives timed; (b) a 30-step request (B = 1) and (c) one held-out
    call of 32 puzzles with the trained EMA, sharded over the mesh's tp group."""
    import gc

    import torch

    from diffassemble_tpu_torch.train.device_data import gather_batch
    from diffassemble_tpu_torch.parallel import tensor
    from diffassemble_tpu_torch.parallel.mesh import shard_params
    from diffassemble_tpu_torch.train.heldout import heldout_eval

    out = {}
    for dtype in ("float32", "bfloat16"):
        torch.cuda.reset_peak_memory_stats()
        tr, state, batch = _flagship_trainer(mesh, workdir, dtype, f"tp_{dtype}")
        state, rec = _step_record(tr, state, batch)
        if dtype == "bfloat16":
            state, steady = _step_record(tr, state, batch)
            timed = _TimedCollectives()
            state, instrumented = _step_record(tr, state, batch, mock.patch.object(tensor, "dist", timed))
            rec.update(steady_ms=steady["ms"], steady_host_s=steady["host_s"],
                       collectives={"seconds": timed.seconds, "calls": timed.calls, "bytes": timed.bytes,
                                    "step_host_s": instrumented["host_s"]})
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out[dtype] = rec
        del tr, state, batch
        gc.collect()
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    cfg, recipe, model, data, rot_k, own_graph, extras = heldout_setup(EVAL_N)
    shard_params(mesh, model)
    request = gather_batch(data, torch.arange(1, device="cuda"), rot_k[:1])
    reset_counts()
    final, ms, host_s = _timed(lambda: model.sample(request, torch.Generator(device="cuda").manual_seed(3)).final)
    out["request"] = {"final": final.cpu(), "ms": ms, "host_s": host_s, "launches": read_counts(),
                      "routes": read_routes()}
    calls = []
    sample = model.sample

    def timed_sample(*args, **kwargs):
        res, call_ms, call_s = _timed(sample, *args, **kwargs)
        calls.append({"puzzles": args[0].patches.shape[0], "ms": call_ms, "host_s": call_s})
        return res

    model.sample = timed_sample
    reset_counts()
    metrics = heldout_eval(model, data, rot_k, eval_n=EVAL_N)
    out["heldout"] = {"piece_acc": metrics["overall__piece_acc"], "puzzle_acc": metrics["overall_acc"],
                      "puzzles": metrics["overall_nImages"], "calls": calls, "launches": read_counts(),
                      "routes": read_routes(), "max_memory_allocated": torch.cuda.max_memory_allocated()}
    return out


def _trainer_3d(mesh, workdir: Path, label: str):
    """A ``Trainer`` of the 3D model with the easy run's flags
    (``TRAIN3D_FLAGS``: vn_dgcnn_rich from its encoder_init, the
    relative-pose losses) in f32 without warmup on ``mesh``, its state made,
    and this rank's dp slice of the run's first batch of 16 (as the parent
    wrote it)."""
    import dataclasses

    import torch

    from diffassemble_tpu_torch.cli import train_3d
    from diffassemble_tpu_torch.data import FragmentBatch
    from diffassemble_tpu_torch.models import Diffusion3D
    from diffassemble_tpu_torch.parallel.mesh import shard_batch
    from diffassemble_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(train_3d.config_from_args(train3d_args("")), compute_dtype="float32", warmup_steps=0)
    tr = Trainer(Diffusion3D(cfg, device="cuda", seed=0), run_dir=str(workdir / f"{label}_{mesh.rank}"),
                 batch_size=DPTP_BATCH_3D, mesh=mesh, viz_every_eval=0)
    state = tr.new_state()
    batch = FragmentBatch(*torch.load(workdir / "dptp_3d_batch.pt", weights_only=True)).to("cuda")
    return tr, state, shard_batch(mesh, batch)


def step_ratios(rec: dict, ref: dict, rel: float, atol: float, norm_rel: float, loss_rel: float) -> dict:
    """One step's record against another's as ``compare_steps`` holds them,
    without raising: the worst error/tolerance of the gradients, of the
    gradient norms and of the aux's other entries."""
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    out = {"grads": max(float((rec["grads"][k] - g).abs().max()) / (rel * float(g.abs().max()) + atol * gmax)
                        for k, g in ref["grads"].items()), "norms": 0.0, "loss": 0.0}
    for key, want in ref["aux"].items():
        kind, tol = ("norms", norm_rel) if key.startswith("grad_norm") else ("loss", loss_rel)
        out[kind] = max(out[kind], abs(rec["aux"][key] - want) / (tol * abs(want) + 1e-30))
    return out


def dptp_steps(mesh, workdir: Path) -> dict:
    """Phase 22d on one rank of ``mesh`` (or the single process): one f32
    Trainer step of the flagship on the phase's batch of 8 and one f32 step
    of the 3D model with the easy run's flags (``TRAIN3D_FLAGS``, the
    relative-pose losses) on its first batch of 16, each this rank's dp
    slice; with the peak memory of each."""
    import gc

    import torch

    out = {}
    torch.cuda.reset_peak_memory_stats()
    tr, state, batch = _flagship_trainer(mesh, workdir, "float32", "dptp_2d")
    out["2d"] = _step_record(tr, state, batch)[1]
    out["2d"]["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del tr, state, batch
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    out["3d"] = _step_record(*_trainer_3d(mesh, workdir, "dptp_3d"))[1]
    out["3d"]["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


TP_JOBS = {"tp_flagship": tp_flagship, "dptp_steps": dptp_steps}


def _card_job(mesh, job: str, workdir: str) -> dict:
    """``TP_JOBS[job]`` on one rank spawned on the one card, with this
    smoke's settings (f32 without TF32, cuDNN's deterministic algorithms)."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return TP_JOBS[job](mesh, Path(workdir))


def run_tp_ranks(job: str, world: int, workdir: Path) -> tuple[list[dict], float]:
    """``job`` on ``world`` spawned ranks of a (world / TP, TP) mesh on the
    one card (``parallel/dryrun.py:run_on_ranks``); their results by rank
    and the seconds it took. A rank that fails, or ranks that outlast
    ``TP_JOIN_S``, fail the phase (all are stopped)."""
    from diffassemble_tpu_torch.parallel.dryrun import run_on_ranks

    start = time.perf_counter()
    ranks = run_on_ranks(_card_job, world, TP, job, str(workdir), timeout=TP_JOIN_S)
    return ranks, time.perf_counter() - start


def _sum_counts(records: list[dict]) -> tuple[dict, dict]:
    """Launches and launches by route summed over ranks' records."""
    counts = {k: sum(r["launches"][k] for r in records) for k in records[0]["launches"]}
    routes = {k: {route: sum(r["routes"][k].get(route, 0) for r in records)
                  for route in {route for r in records for route in r["routes"][k]}}
              for k in records[0]["routes"]}
    return counts, routes


def _check_step_launches(label: str, recs: list[dict], routes: dict[str, dict[str, int]]) -> None:
    """Each rank's step launched each kernel by route as given."""
    for r, rec in enumerate(recs):
        if rec["launches"] != counts_of(routes) or by_route(rec["routes"]) != routes:
            raise AssertionError(f"{label}, rank {r}: launches {rec['launches']}, by route {rec['routes']}; "
                                 f"expected {routes}")


def timing_tp(max_err: dict[str, float]) -> list[dict]:
    """The three kernels at a tp rank's shapes (H = HEADS / TP, N = 908,
    fully connected, B = 1 as a request's and 8 as a train step's, Dh 32 and
    144): each held against its plain version in bf16 and f32, on the
    tensor cores as the steps launch them (``_check_kernels``, updating
    ``max_err``),
    then timed in bf16: the forward at B = 1 and all three at B = 8, each on
    the tensor cores, beside their plain versions, their bound and SDPA
    (``time_forward_on_mask``, ``time_on_masks``); and in f32 at B = 8."""
    import torch

    h = HEADS // TP
    gen = torch.Generator(device="cuda").manual_seed(4)
    ones = [torch.ones((b, N_NODES, N_NODES), dtype=torch.bool, device="cuda") for b in (1, TRAIN_BATCH)]
    for mask, label in zip(ones, ("a tp rank's request", "a tp rank's train step")):
        for dh in MAIN_HEAD_DIMS:
            for dtype in (torch.bfloat16, torch.float32):
                _check_kernels(label, mask, dh, dtype, gen, max_err, heads=h)
    rows = (time_forward_on_mask(ones[0], "a tp rank's request", h, MAIN_HEAD_DIMS, gen)
            + time_on_masks(ones[1], "a tp rank's train step", MAIN_HEAD_DIMS, gen, heads=h))
    for r in rows:
        if r["route"] != "tensor_cores":
            raise AssertionError(f"{r['kernel']} at H={h} Dh={r['dh']} takes the {r['route']} route")
    rows += time_on_masks(ones[1], "a tp rank's train step", MAIN_HEAD_DIMS, gen, heads=h, dtype="float32")
    for r in rows:
        r.update(h=h, main_path=False, tensor_parallel=True, launches_per_step=dict(STEP_LAUNCHES)[r["dh"]])
    return rows


def kernels_tp_3d(nb, max_err: dict[str, float]) -> None:
    """The kernels at the shapes the dp 2 × tp 2 3D rank step gives them:
    each dp place's half of the step's batch (B = 8, N = 8, padding parts
    with empty query rows and unattended keys), H = heads / TP, the
    denoiser's head widths (Dh 32 and 264), against their plain versions in
    bf16 and f32 (``_check_kernels``: phase 3's tolerances, exact zeros and
    the route, the fused kernel's at all but bf16 Dh 32), updating
    ``max_err``."""
    import torch

    from diffassemble_tpu_torch.cli import train_3d

    cfg = train_3d.config_from_args(train3d_args(""))
    mask = torch.as_tensor(nb.adj).cuda()
    if mask.shape[0] != DPTP_BATCH_3D:
        raise AssertionError(f"the dp2 x tp2 3D batch has {mask.shape[0]} objects, expected {DPTP_BATCH_3D}")
    half = DPTP_BATCH_3D // 2
    gen = torch.Generator(device="cuda").manual_seed(6)
    for place in range(2):
        m = mask[place * half:(place + 1) * half].contiguous()
        for dh in head_widths_3d(cfg):
            for dtype in (torch.bfloat16, torch.float32):
                _check_kernels(f"dp2 x tp2 3D rank, dp place {place}", m, dh, dtype, gen, max_err,
                               heads=cfg.heads // TP)


def timing_rest_shapes() -> list[dict]:
    """The forward kernel at the shapes of phases 20 and 21a, which had no
    timing of their own: ``evaluate``'s calls (B = 4, N = 908, H = 8, fully
    connected as the CLI serves, Dh 32 and 144) and the 3D export's call (the
    easy checkpoint's protocol cut to its first 4 objects, N = 8, its heads
    at Dh 32 and 264), beside the plain version, the bound over the attended
    pairs and SDPA (``time_forward_on_mask``)."""
    import torch

    from diffassemble_tpu_torch.train.heldout3d import model_from_asset

    gen = torch.Generator(device="cuda").manual_seed(5)
    mask = torch.ones((4, N_NODES, N_NODES), dtype=torch.bool, device="cuda")
    rows = time_forward_on_mask(mask, "evaluate, B = 4", HEADS, MAIN_HEAD_DIMS, gen)
    model, cfg, protocol, _ = model_from_asset(ASSET_3D, "cuda")
    mask = first_batch_3d({**protocol, "batch": 4}).adj.contiguous()
    widths = (cfg.hidden_dim // cfg.heads, (model.feat_dim + 64) // cfg.heads)
    rows += time_forward_on_mask(mask, "3D export, 4 objects", cfg.heads, widths, gen)
    for r in rows:
        r["main_path"] = False  # the per-step sums of the kernels line are phases 4-5's
    return rows


def tensor_parallel(workdir: Path, max_err: dict[str, float]) -> tuple[dict[str, tuple], list[dict]]:
    """Phase 22, the twenty-second main path: tensor parallelism on one card
    (``parallel/mesh.py:shard_params``, ``parallel/tensor.py``), its ranks
    processes in a gloo group over CUDA tensors.

    - tp = 2, dp = 1 at the flagship's full width (Exophormer, 4 layers of 8
      heads, each rank 4 of them; 8 virtual nodes, hidden 256, N = 908, the
      flagship's encoder_init): (a) one Trainer step at batch 8 over the 10%
      expander in f32 against the single-process step on the card
      (``parallel/dryrun.py:GRAD_TOL``; 4 + 4 + 4 launches a rank, all on
      the tensor cores, 3xTF32), then in bf16 against the bf16 step (its
      loss, gradient norms and gradients within ``TP_BF16_TOL``; 4 + 4 + 4 on
      the tensor cores), the ranks' whole parameters equal after each and
      equal to the single-process optimizer's update on the rank's
      gradients (``hold_update``); then a steady step and one with the tp
      collectives timed; (b) a 30-step request (B = 1) with the trained EMA,
      120 forward launches a rank on the tensor cores, its final positions
      within ``TP_REQUEST_TOL`` of the single process's; (c) one held-out
      call of 32 puzzles (bench.py's protocol) with the trained EMA, 120
      forward launches a rank, piece_acc within ``TP_PIECE_ACC_TOL`` of the
      single process's on the same puzzles and draws;
    - dp = 2 × tp = 2 (four processes on the one card): one f32 Trainer step
      of the flagship at batch 8 (4 a dp place) and one of the 3D model with
      the easy run's flags at batch 16 (8 a dp place) against one process on
      the whole batch (``GRAD_TOL``, the 3D gradients within
      ``DPTP_3D_GRAD_REL``; each update by ``hold_update``), each rank's
      peak memory printed. Every step here has no warmup, so that it moves
      the parameters.

    The kernels are first held against their plain versions at a rank's
    shapes: N = 908 (``timing_tp``) and the dp 2 × tp 2 3D step's N = 8
    (``kernels_tp_3d``, the fused kernel's). The single-process references
    run in this process next; their f32 and bf16 flagship steps are printed
    by CUDA events with their launches by route, gated as a rank's, and
    kept as paths. Returns, by path, (launches summed over the
    ranks, by route, the result), and the kernels' rows at a rank's shapes
    (``timing_tp``) and at phases 20 and 21a's (``timing_rest_shapes``)."""
    import gc

    import numpy as np
    import torch

    from diffassemble_tpu_torch.parallel.dryrun import GRAD_TOL, compare_steps
    from diffassemble_tpu_torch.parallel.mesh import Mesh

    rows = timing_tp(max_err) + timing_rest_shapes()
    cfg = flagship_config()
    rng = np.random.default_rng(22)
    batch = seeded_puzzles(30, TRAIN_BATCH, cfg.rotation, rng)
    adj = seeded_puzzles(30, 1, cfg.rotation, rng, degree="10%").adj
    torch.save(tuple(torch.as_tensor(np.asarray(f)) for f in batch._replace(adj=batch.adj & adj)),
               workdir / "tp_batch.pt")
    nb3 = loss_inputs_3d()[0]
    kernels_tp_3d(nb3, max_err)
    torch.save(tuple(torch.as_tensor(np.asarray(f)) for f in nb3), workdir / "dptp_3d_batch.pt")

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        start = time.perf_counter()
        ref = tp_flagship(Mesh(), workdir)
        ref_dptp = dptp_steps(Mesh(), workdir)
        ref_s = time.perf_counter() - start
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gc.collect()
    torch.cuda.empty_cache()
    phase(f"tensor parallel: single-process references in {ref_s:.1f} s (f32 step {ref['float32']['ms']:.2f} ms, "
          f"bf16 step {ref['bfloat16']['ms']:.2f} ms / steady {ref['bfloat16']['steady_ms']:.2f} ms by CUDA events, "
          f"request {ref['request']['ms']:.2f} ms, held-out call {ref['heldout']['calls'][0]['ms']:.2f} ms, "
          f"piece_acc {ref['heldout']['piece_acc']!r}; peak {ref['float32']['max_memory_allocated'] / 2**30:.2f} / "
          f"{ref['bfloat16']['max_memory_allocated'] / 2**30:.2f} GiB)")
    # the one-process flagship steps at batch 8, all on the tensor cores (f32: 3xTF32)
    paths = {}
    one = {"float32": f32_step_routes_2d(), "bfloat16": {k: on_routes(tensor_cores=n)
                                                         for k, n in launches_of(4, 4, 4).items()}}
    for dtype, routes in one.items():
        _check_step_launches(f"one-process {dtype} step", [ref[dtype]], routes)
        phase(f"one-process flagship {dtype} step, batch {TRAIN_BATCH} (first step): {ref[dtype]['ms']:.2f} ms by "
              f"CUDA events, {ref[dtype]['host_s']:.3f} s host; launches by route "
              f"{ {k: {r: c for r, c in v.items() if c} for k, v in ref[dtype]['routes'].items()} }")
        paths[f"one_process_step_{dtype}"] = (ref[dtype]["launches"], ref[dtype]["routes"],
                                              {"ms": ref[dtype]["ms"], "host_s": ref[dtype]["host_s"]})

    rounding = step_ratios(ref["bfloat16"], ref["float32"], *TP_BF16_TOL)
    phase(f"bf16 rounding in one process: the bf16 step against the f32 step on the same weights and batch, "
          f"under TP_BF16_TOL {TP_BF16_TOL} (the tp step is held to 1): worst err/tol gradients "
          f"{rounding['grads']:.3f}, gradient norms {rounding['norms']:.3f}, loss terms {rounding['loss']:.3f}")

    ranks, seconds = run_tp_ranks("tp_flagship", TP, workdir)
    for dtype, tol in (("float32", GRAD_TOL["efficientnet_b0"]), ("bfloat16", TP_BF16_TOL)):
        recs = [r[dtype] for r in ranks]
        worst = compare_steps(recs, ref[dtype], *tol, steps=dtype == "float32")
        worst["update_replay"] = hold_update(f"tp {dtype} step", recs[0], ref[dtype]["optimizer"])
        _check_step_launches(f"tp {dtype} step", recs, one[dtype])
        if dtype == "bfloat16":
            off = update_readings(recs[0], ref[dtype], tol[0])
            phase(f"tp=2 bf16 step's update against one process's (a reading): {len(off)} of {len(recs[0]['grads'])} "
                  f"tensors beyond rel {tol[0]} of their largest move; (err/tol, tensor, largest gradient, largest "
                  f"gradient difference): {[(round(r, 2), k, f'{g:.3e}', f'{d:.3e}') for r, k, g, d in off]}")
        phase(f"tp=2 {dtype} step, flagship batch 8: worst err/tol {worst} (tol {tol}; update_replay: the largest "
              f"difference from the single-process optimizer on the rank's gradients); launches a rank "
              f"{recs[0]['launches']} ({F32_STEP_ROUTES if dtype == 'float32' else 'all on the tensor cores'}); "
              f"{recs[0]['ms']:.2f} / {recs[1]['ms']:.2f} ms by CUDA events, "
              f"{recs[0]['host_s']:.3f} s host (one process {ref[dtype]['ms']:.2f} ms); peak "
              f"{[round(r['max_memory_allocated'] / 2**30, 2) for r in recs]} GiB")
        paths[f"tp_step_{dtype}"] = (*_sum_counts(recs), {"worst": worst, "ms": [r["ms"] for r in recs],
                                                          "host_s": [r["host_s"] for r in recs],
                                                          "one_process_ms": ref[dtype]["ms"],
                                                          "max_memory_allocated": [r["max_memory_allocated"]
                                                                                   for r in recs]})
    bf = [r["bfloat16"] for r in ranks]
    coll = [r["collectives"] for r in bf]
    share = [c["seconds"] / c["step_host_s"] for c in coll]
    paths["tp_step_bfloat16"][2].update(steady_ms=[r["steady_ms"] for r in bf],
                                        steady_host_s=[r["steady_host_s"] for r in bf],
                                        one_process_steady_ms=ref["bfloat16"]["steady_ms"], collectives=coll)
    phase(f"tp=2 bf16 steady step: {[round(r['steady_ms'], 2) for r in bf]} ms by CUDA events, "
          f"{[round(r['steady_host_s'], 3) for r in bf]} s host (one process {ref['bfloat16']['steady_ms']:.2f} ms, "
          f"{ref['bfloat16']['steady_host_s']:.3f} s); the tp collectives: {coll[0]['calls']} all-reduces of "
          f"{coll[0]['bytes'] / 2**20:.1f} MiB, {[round(c['seconds'], 3) for c in coll]} s of an instrumented "
          f"step's {[round(c['step_host_s'], 3) for c in coll]} s host ({[round(s, 3) for s in share]})")

    finals = [r["request"]["final"] for r in ranks]
    err = float((finals[0] - ref["request"]["final"]).abs().max())
    for r, rec in enumerate(ranks):
        if rec["request"]["launches"] != launches_of(fwd=120) or \
                rec["request"]["routes"]["masked_attention_fwd"] != on_routes(tensor_cores=120):
            raise AssertionError(f"tp request, rank {r}: launches {rec['request']['launches']}, by route "
                                 f"{rec['request']['routes']}; expected 120 forward on the tensor cores")
    if not (torch.equal(finals[0], finals[1]) and torch.isfinite(finals[0]).all() and err <= TP_REQUEST_TOL):
        raise AssertionError(f"tp request: final positions {err:.3e} from one process's (tol {TP_REQUEST_TOL}), "
                             f"ranks equal {torch.equal(finals[0], finals[1])}")
    phase(f"tp=2 request (B=1, 30 steps, trained EMA): max|d| {err:.3e} from one process (tol {TP_REQUEST_TOL}), "
          f"ranks bit-equal; 120 forward launches a rank on the tensor cores; "
          f"{[round(r['request']['ms'], 2) for r in ranks]} ms by CUDA events, "
          f"{[round(r['request']['host_s'], 3) for r in ranks]} s host (one process {ref['request']['ms']:.2f} ms, "
          f"{ref['request']['host_s']:.3f} s)")
    paths["tp_request"] = (*_sum_counts([r["request"] for r in ranks]),
                           {"max_abs_err": err, "ms": [r["request"]["ms"] for r in ranks],
                            "host_s": [r["request"]["host_s"] for r in ranks], "one_process_ms": ref["request"]["ms"],
                            "one_process_host_s": ref["request"]["host_s"]})

    held = [r["heldout"] for r in ranks]
    gap = abs(held[0]["piece_acc"] - ref["heldout"]["piece_acc"])
    for r, h in enumerate(held):
        if h["launches"] != launches_of(fwd=120) \
                or h["routes"]["masked_attention_fwd"]["cuda_cores"] or h["puzzles"] != EVAL_N:
            raise AssertionError(f"tp held-out call, rank {r}: {h['puzzles']} puzzles, launches {h['launches']}, "
                                 f"by route {h['routes']}")
    if not (held[0]["piece_acc"] == held[1]["piece_acc"] and gap <= TP_PIECE_ACC_TOL):
        raise AssertionError(f"tp held-out call: piece_acc {[h['piece_acc'] for h in held]} against one process's "
                             f"{ref['heldout']['piece_acc']} (tol {TP_PIECE_ACC_TOL})")
    phase(f"tp=2 held-out call of {EVAL_N} puzzles (trained EMA): piece_acc {held[0]['piece_acc']!r}, one process "
          f"{ref['heldout']['piece_acc']!r} (gap {gap:.5f}, tol {TP_PIECE_ACC_TOL}); "
          f"{[round(h['calls'][0]['ms'], 2) for h in held]} ms by CUDA events (one process "
          f"{ref['heldout']['calls'][0]['ms']:.2f} ms); peak "
          f"{[round(h['max_memory_allocated'] / 2**30, 2) for h in held]} GiB; ranks took {seconds:.1f} s in all")
    paths["tp_heldout"] = (*_sum_counts(held), {"piece_acc": held[0]["piece_acc"],
                                                "one_process_piece_acc": ref["heldout"]["piece_acc"],
                                                "calls": [h["calls"] for h in held],
                                                "one_process_calls": ref["heldout"]["calls"]})

    ranks, seconds = run_tp_ranks("dptp_steps", 2 * TP, workdir)
    # f32 steps: the 2D step's 4 + 4 + 4 launches (N = 908), all on the tensor cores; the 3D step's 8
    # forward and 8 backward launches on the small-graph route (N = 8)
    for family, routes in (("2d", f32_step_routes_2d()), ("3d", step_routes_3d(2, 4, "float32"))):
        recs = [r[family] for r in ranks]
        tol = GRAD_TOL["efficientnet_b0"] if family == "2d" else (DPTP_3D_GRAD_REL, *GRAD_TOL["3d"][1:])
        worst = compare_steps(recs, ref_dptp[family], *tol, steps=family == "2d")
        worst["update_replay"] = hold_update(f"dp2 x tp2 {family} step", recs[0], ref_dptp[family]["optimizer"])
        _check_step_launches(f"dp2 x tp2 {family} step", recs, routes)
        if family == "3d":
            off = update_readings(recs[0], ref_dptp[family], tol[0])
            phase(f"dp=2 x tp=2 3d step's update against one process's (a reading): {len(off)} of "
                  f"{len(recs[0]['grads'])} tensors beyond rel {tol[0]} of their largest move; (err/tol, tensor, "
                  f"largest gradient, largest gradient difference): "
                  f"{[(round(r, 2), k, f'{g:.3e}', f'{d:.3e}') for r, k, g, d in off]}")
        b = TRAIN_BATCH if family == "2d" else DPTP_BATCH_3D
        phase(f"dp=2 x tp=2 {family} f32 step, batch {b} ({b // 2} a dp place), four processes on one card: worst "
              f"err/tol {worst} (tol {tol}); launches a rank {recs[0]['launches']} "
              f"{f'({F32_STEP_ROUTES})' if family == '2d' else 'on the small-graph route'}; "
              f"{[round(r['ms'], 2) for r in recs]} ms by CUDA events (one process {ref_dptp[family]['ms']:.2f} ms); "
              f"peak {[round(r['max_memory_allocated'] / 2**30, 2) for r in recs]} GiB a rank (one process "
              f"{ref_dptp[family]['max_memory_allocated'] / 2**30:.2f} GiB)")
        paths[f"dptp_step_{family}"] = (*_sum_counts(recs), {
            "worst": worst, "batch": b, "ms": [r["ms"] for r in recs], "one_process_ms": ref_dptp[family]["ms"],
            "max_memory_allocated": [r["max_memory_allocated"] for r in recs],
            "one_process_max_memory_allocated": ref_dptp[family]["max_memory_allocated"]})
    phase(f"tensor parallel: dp=2 x tp=2 ranks took {seconds:.1f} s")
    return paths, rows


def kernel_line(errs: dict, rows: list[dict], sweep: list[dict], serve: tuple, train: tuple, heldout: tuple,
                recipe_: tuple, mixed_: tuple, ddp: tuple, eval3d_: tuple, train3d_: tuple, e_more: dict,
                t_more: dict, more_2d: dict, rest: dict, tp_paths: dict) -> dict:
    """The kernels' JSON line; ``serve`` and ``train`` are (launches,
    launches by route, seconds per request or per steady step), ``heldout``,
    ``recipe_``, ``mixed_``, ``eval3d_`` and ``train3d_`` (launches, launches
    by route, the phase's result), ``ddp`` (launches, launches by route),
    ``e_more`` and ``t_more`` the results of ``eval3d_more`` and
    ``train3d_more``, ``more_2d`` the equivariant 2D family's paths by name
    and ``rest`` those of phases 17-21 (launches, launches by route, the
    phase's result, or for the 3D DDP step no result), ``tp_paths`` those of
    phase 22 (launches summed over the ranks, by route, the result); the
    forward's, dQ's and dK/dV's ``tensor_parallel`` entries sum their rows at
    a tp rank's shapes (H = 4) over a denoiser step or a train step. The fused small-graph
    backward's figures are per 3D train step of the easy run's flags (its
    launches at Dh 264 on the run's first batch, N = 8), beside the
    CUDA-core pair it replaced on the same inputs; the small-graph forward's
    per 3D held-out call of the easy checkpoint (its launches at Dh 264 on
    the protocol's first call, N = 8), beside the CUDA-core forward it
    replaced. The f32 tensor-core forward's, dQ's and dK/dV's figures are per
    f32 train step of the flagship (B = 8, H = 8, N = 908, fully connected)
    beside the CUDA-core kernel on the same inputs. Each entry's launches are those of its
    C functions (``LINE_ENTRIES``), as the wrappers counted them by the
    function they launched; an entry that no main path launched fails."""
    from diffassemble_tpu_torch import REFERENCE_PACKAGE
    from diffassemble_tpu_torch.ops import cuda_attention

    cli3d = (eval3d_[2]["cli_launches"], eval3d_[2]["cli_routes"])
    f32_eval = (heldout[2]["float32"]["launches"], heldout[2]["float32"]["routes"])
    paths = {"serve": serve, "train": train, "heldout_eval": heldout, "heldout_eval_f32": f32_eval,
             "recipe": recipe_, "mixed": mixed_,
             "ddp": ddp, "eval3d_cli": cli3d, "eval3d_heldout": eval3d_, "train3d": train3d_,
             **{f"eval3d_{name}_cli": (v[2]["cli_launches"], v[2]["cli_routes"]) for name, v in e_more.items()},
             **{f"eval3d_{name}": v for name, v in e_more.items()},
             **{f"train3d_{label}": v for label, v in t_more.items()}, **more_2d, **rest, **tp_paths}
    root = Path(__file__).resolve().parent

    def source(fn: str) -> str:  # the source file that holds C function fn, in the repo
        return str(cuda_attention.SOURCES[cuda_attention._SIGNATURES[fn][0]].relative_to(root))

    out = []
    for name, functions in LINE_ENTRIES.items():
        main = next(iter(functions.values()))  # the entry's kernel on the main paths' timed shapes
        kernel = "masked_attention_fwd" if name == FWD_SMALL else name.removesuffix("_tc_f32")  # its wrapper
        if name == FWD_SMALL:
            # per 3D held-out call of the easy checkpoint: its launches on the protocol's first call (N = 8)
            rs = [r for r in rows if r["function"] == main and r["mask"] == "3D protocol, first call"]
            calls = {sum(call) for call in zip(*(r["launches_per_3d_call"] for r in rs))}
            if len(calls) != 1:
                raise AssertionError(f"the 3D held-out calls launched the small-graph forward {calls} times")
            per = [(r, r["launches_per_3d_call"][0]) for r in rs]
            more = {"cuda_core_fwd_ms": sum(r["cuda_core_fwd_ms"] * c for r, c in per)}
            about = (f"one 3D held-out call of the easy checkpoint: {calls.pop()} launches at Dh="
                     f"{'/'.join(str(r['dh']) for r in rs)}, B={rs[0]['b']}, H={HEADS}, N={rs[0]['n']}, bf16, "
                     f"route small_graph; cuda_core_fwd_ms: the CUDA-core forward it replaced, same inputs")
        elif name == FUSED:
            # per 3D train step of the easy run's flags: its launches on the run's first batch (N = 8)
            rs = [r for r in rows if r["function"] == main and r["mask"] == "3D training, first batch"]
            steps = {sum(step) for step in zip(*(r["launches_per_step"] for r in rs))}
            if len(steps) != 1:
                raise AssertionError(f"the 3D train steps launched the fused kernel {steps} times")
            per = [(r, r["launches_per_step"][0]) for r in rs]
            more = {"library_computes": "dQ, dK and dV in one SDPA backward, as the fused kernel",
                    "cuda_core_pair_ms": sum((r["cuda_core_pair_ms"]["dq_ms"] + r["cuda_core_pair_ms"]["dkv_ms"])
                                             * c for r, c in per)}
            about = (f"one 3D train step of the easy run's flags: {steps.pop()} launches at Dh="
                     f"{'/'.join(str(r['dh']) for r in rs)}, B={rs[0]['b']}, H={HEADS}, N={rs[0]['n']}, bf16, "
                     f"route small_graph; cuda_core_pair_ms: the dQ + dK/dV pair it replaced, same inputs")
        else:
            # the bf16 forward's figures are per denoiser step at the serving shapes (B = 1); the bf16
            # backward kernels' per train step (B = 8), the f32 ones' per f32 train step
            b = 1 if name == "masked_attention_fwd" else TRAIN_BATCH
            per = [(r, r["launches_per_step"]) for r in rows
                   if r["function"] == main and r["b"] == b and r["n"] == N_NODES and r["main_path"]]
            tp = [r for r in rows if r.get("tensor_parallel") and r["function"] == main and r["b"] == b]
            keys = ["ms", "plain_ms", "library_ms", "bound_ms"]
            more = {} if kernel == "masked_attention_fwd" else {
                "library_computes": "dQ, dK and dV in one SDPA backward, the same call in both backward rows: set "
                                    "it against the sum of their ms"}
            what = f"{'denoiser step' if b == 1 else 'train step'}, {per[0][0]['dtype']}"
            if "cuda_core_pair_ms" in per[0][0] or "cuda_core_fwd_ms" in per[0][0]:
                # an f32 tensor-core kernel: the CUDA-core kernel on the same inputs beside it
                for r in (*(r for r, _ in per), *tp):
                    r["cuda_core_ms"] = (r["cuda_core_fwd_ms"] if kernel == "masked_attention_fwd" else
                                         r["cuda_core_pair_ms"]["dq_ms" if kernel == "masked_attention_bwd_dq"
                                                                else "dkv_ms"])
                keys.append("cuda_core_ms")
                more["cuda_core_ms"] = sum(r["cuda_core_ms"] * c for r, c in per)
            about = (f"one {what}: 3 launches at Dh=32 and 1 at Dh=144, B={b}, H={HEADS}, N={N_NODES}, route "
                     f"{per[0][0]['route']}" + ("; cuda_core_ms: the CUDA-core kernel on the same inputs"
                                                if "cuda_core_ms" in more else ""))
            more["tensor_parallel"] = {
                **{key: sum(r[key] * r["launches_per_step"] for r in tp) for key in keys},
                "times_are_for": f"a tp rank's {what}: H={HEADS // TP}, B={b}, N={N_NODES}, 3 launches at Dh=32 "
                                 f"and 1 at Dh=144, route {per[0][0]['route']}"}
        step = {key: sum(r[key] * c for r, c in per) for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_route = {path: {route: paths[path][1][FUNCTIONS].get(fn, 0) for route, fn in functions.items()}
                    for path in paths}
        by_path = {path: sum(n.values()) for path, n in by_route.items()}
        if not sum(by_path.values()):
            raise AssertionError(f"{name}: none of {sorted(functions.values())} was launched on a main path")
        out.append({
            "name": name,
            "route": "cuda",
            "source": source(main),
            "sources_by_route": {route: source(fn) for route, fn in functions.items()},
            "replaces": ", ".join(f"{REFERENCE_PACKAGE}/{x}" for x in cuda_attention.REPLACES[kernel]),
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_by_route": by_route,
            "max_abs_err": max(errs[fn] for fn in functions.values()),
            "ms": step["ms"],
            "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"],
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r, _ in per) else "bytes",
            "library_ms": step["library_ms"],
            **more,
            "times_are_for": about,
            "per_shape": [r for r in rows if r["function"] in functions.values()],
        })
    out[1]["tensor_parallel"]["paths"] = {name: r[2] for name, r in tp_paths.items()}
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
    out[1]["rest_2d_3d"] = {name: {k: v for k, v in r[2].items() if k != "steps"} for name, r in rest.items()
                            if len(r) > 2}
    return {"kernels": out}


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--only", choices=["tensor_parallel", "f32_rounding"],
                    help="instead of the smoke run, build the kernels and run phase 22 alone, or read the f32 "
                         "tensor-core kernels' error against emulations of their rounding (f32_rounding)")
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
    if args.only == "f32_rounding":
        f32_rounding()
    elif args.only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
            tensor_parallel(Path(tmp), dict.fromkeys(ERR_KEYS, 0.0))
    if args.only:
        phase("done")
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
    rest = rest_of_the_family(train[3])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        tp_paths, rows_tp = tensor_parallel(Path(tmp), errs)
    rows += rows_tp
    # each main path's (launches, launches by route)
    def cli(result):
        return result["cli_launches"], result["cli_routes"]

    f32_eval = heldout[2]["float32"]
    paths = {"serve": serve[:2], "train": train[:2], "held-out eval": heldout[:2],
             "held-out eval f32": (f32_eval["launches"], f32_eval["routes"]), "recipe": rec[:2],
             "mixed": mix[:2], "ddp": ddp[:2], "3D run_3d --evaluate": cli(e3d[2]),
             "3D held-out": e3d[:2], "3D train": t3d[:2],
             **{f"3D {name} run_3d --evaluate": cli(v[2]) for name, v in e_more.items()},
             **{f"3D {name} held-out": v[:2] for name, v in e_more.items()},
             **{f"3D train {label}": v[:2] for label, v in t_more.items()},
             **{name: v[:2] for name, v in more_2d.items()}, **{name: v[:2] for name, v in rest.items()},
             **{name: v[:2] for name, v in tp_paths.items()}}
    # these launch the forward kernel alone
    sampling_only = {"serve", "held-out eval", "held-out eval f32", "3D run_3d --evaluate", "3D held-out", "rot_ms_heldout",
                     "discrete_heldout", "serve_norm_stats", "angle_sample", "evaluate_rot30",
                     "evaluate_rot30_recipe_images", "evaluate_rot_ms", "evaluate_rot_ms_protocol_sizes",
                     "export_meshes_3d", "tp_request", "tp_heldout",
                     *(f"3D {name} {what}" for name in e_more for what in ("run_3d --evaluate", "held-out"))}
    no_attention = {"gcn"}  # its backbone is matrix products: it must launch no kernel (phase 17)
    # 3D training: the backward of the wide last layer (N <= 32, off the tensor cores) is the fused
    # kernel's; the f32 steps have no tensor-core layer, so no dQ or dK/dV launch
    fused_paths = {"3D train", *(f"3D train {label}" for label in t_more), "ddp_3d", "dptp_step_3d"}
    fused_only = {"dptp_step_3d"}

    def path_kernels(path: str) -> set[str]:
        if path in no_attention:
            return set()
        if path in sampling_only:
            return {"masked_attention_fwd"}
        pair = set() if path in fused_only else {"masked_attention_bwd_dq", "masked_attention_bwd_dkv"}
        return {"masked_attention_fwd", *pair, *({FUSED} if path in fused_paths else ())}

    idle = {path: counts for path, (counts, _) in paths.items() if any(counts[k] == 0 for k in path_kernels(path))}
    if idle:
        raise AssertionError(f"a kernel of a main path was not launched: {idle}")
    # every 3D path's forward at N <= 32 off the tensor cores is the small-graph kernel's: it launches
    # there, and the CUDA-core forward never
    paths_3d = {path for path in paths if path.startswith("3D ")} | {"export_meshes_3d", "ddp_3d", "dptp_step_3d"}
    fwd_3d = {path: paths[path][1]["masked_attention_fwd"] for path in paths_3d & set(paths)}
    off_route = {path: per for path, per in fwd_3d.items() if per["cuda_cores"] or not per["small_graph"]}
    if off_route or len(fwd_3d) != len(paths_3d):
        raise AssertionError(f"3D paths' forward launches by route {off_route}; paths missing "
                             f"{sorted(paths_3d - set(fwd_3d))}")
    phase(f"3D paths: {len(paths_3d)}, each forward at N <= 32 off the tensor cores on the small-graph route "
          f"({sum(r['small_graph'] for r in fwd_3d.values())} launches), none on the CUDA cores")
    line = kernel_line(errs, rows, sweep, serve, train, heldout, rec, mix, ddp, tuple(e3d), tuple(t3d), e_more,
                       t_more, more_2d, rest, tp_paths)
    phase("done")
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
