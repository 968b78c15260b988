#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diffassemble_tpu_torch``) on one GPU.

    python3 chip_smoke.py                  # the smoke run
    python3 chip_smoke.py --profile        # one serving request under torch.profiler
    python3 chip_smoke.py --profile train  # one full-width train step under torch.profiler
    python3 chip_smoke.py --profile eval   # one held-out call of 32 puzzles, trained weights

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
   104 and 264, in both types, on the B = 1 expander and the
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
   the same puzzles over a fully connected graph and in calls of 8.

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
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, NVIDIA H100 SXM data sheet
H100_F32_FLOPS = 67e12  # non-tensor-core f32 peak
H100_BYTES_PER_S = 3.35e12
N_NODES = 908  # 900 pieces + 8 virtual nodes
HEADS = 8
STEP_LAUNCHES = ((32, 3), (144, 1))  # (head width, launches) per denoiser step or train step
REQUESTS = 3
TRAIN_BATCH = 8
TRAIN_STEPS, RESUME_STEPS = 3, 2
# the flagship's training recipe on the rotation CLI (weights/diffusion2d_rot30/config.json
# and data.json; batch 8 as the 900-piece recipe); encoder_init is left out: the
# pretrained npz is not in the chip copy, and the weights are seeded
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
OTHER_HEAD_DIMS = (20, 104, 264)  # not a multiple of 8; the 3D checkpoints' last layers

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


def bound_ms(kernel: str, b: int, n: int, h: int, dh: int, elem_bytes: int) -> tuple[float, str]:
    """Least time on an H100 for one launch: the larger of its operations over
    the peak rate for the type and the bytes it must move (each input read
    once, each output written once) over the memory rate.

    forward: S and O·V, 4·B·H·N²·Dh; reads q, k, v and the mask, writes O, L.
    dQ: S, dP and dQ, 6·B·H·N²·Dh; reads q, k, v, dO, L, Δ and the mask, writes dQ.
    dK/dV: S, dP, dV and dK, 8·B·H·N²·Dh; reads q, k, v, dO, L, Δ and the mask,
    writes dK and dV."""
    tensor = b * n * h * dh * elem_bytes  # one (B, N, H, Dh) tensor
    row = 4.0 * b * h * n  # one (B, H, N) f32 tensor
    mask = b * n * n
    flops, nbytes = {
        "masked_attention_fwd": (4, 4 * tensor + row + mask),
        "masked_attention_bwd_dq": (6, 5 * tensor + 2 * row + mask),
        "masked_attention_bwd_dkv": (8, 6 * tensor + 2 * row + mask),
    }[kernel]
    t_ops = flops * b * h * n * n * dh / (H100_BF16_FLOPS if elem_bytes == 2 else H100_F32_FLOPS)
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
                   misaligned: bool = False) -> None:
    """The three kernels against their plain versions on one mask, width and
    type, on the route these call for: the tensor cores for bf16 at the main
    paths' widths, else (and for ``misaligned`` inputs, 2 bytes off a 16-byte
    boundary) the CUDA cores; raises on a disagreement or another route.
    Updates ``max_err`` per kernel."""
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
                here.append({"kernel": kernel, "b": b, "dh": dh, "route": route, "main_path": main,
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


def training(run_dir: Path) -> tuple[dict[str, int], dict[str, dict[str, int]], list[float]]:
    """The second main path: ``run_2d`` of the rotation CLI at full width,
    batch 8, 30×30; then a resume from its checkpoint. Each train step is
    timed (host clock to a synchronize) and its launches counted."""
    import torch

    from diffassemble_tpu_torch.cli import train_2d_rot
    from diffassemble_tpu_torch.train import trainer as trainer_mod

    steps = []
    make_step = trainer_mod.make_train_step

    def counted_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def counted(state, batch):
            torch.cuda.synchronize()
            start, before, before_routes = time.perf_counter(), read_counts(), read_routes()
            new, aux = step(state, batch)
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in read_counts().items()}
            rec = {"step": new.step, "seconds": time.perf_counter() - start, "launches": launched,
                   "routes": routes_since(before_routes),
                   **{k: float(aux[k]) for k in ("total_loss", "grad_norm", "grad_norm/encoder",
                                                 "grad_norm/denoiser", "grad_nonfinite")}}
            steps.append(rec)
            phase(f"train step {rec['step']}: {rec['seconds']:.3f} s, launches {launched}, "
                  f"loss {rec['total_loss']:.4f}, grad_norm {rec['grad_norm']:.4f} "
                  f"(encoder {rec['grad_norm/encoder']:.4f}, denoiser {rec['grad_norm/denoiser']:.4f})")
            return new, aux

        return counted

    argv = ["train_2d_rot", *TRAIN_FLAGS, "--run_dir", str(run_dir)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with mock.patch.object(trainer_mod, "make_train_step", counted_make_train_step):
        with mock.patch.object(sys, "argv", argv + ["-max_steps", str(TRAIN_STEPS)]):
            train_2d_rot.main()
        first_run = len(steps)
        with mock.patch.object(sys, "argv", argv + ["-max_steps", str(TRAIN_STEPS + RESUME_STEPS)]):
            train_2d_rot.main()
    counts, routes = read_counts(), read_routes()
    peak = torch.cuda.max_memory_allocated()
    ckpts = sorted(int(p.name) for p in (run_dir / "checkpoints").iterdir() if p.name.isdigit())
    expected = dict.fromkeys(KERNEL_SOURCES, 4)
    on_tensor_cores = dict.fromkeys(KERNEL_SOURCES, {"tensor_cores": 4, "cuda_cores": 0})
    if first_run != TRAIN_STEPS or [s["step"] for s in steps] != list(range(1, TRAIN_STEPS + RESUME_STEPS + 1)):
        raise AssertionError(f"expected steps 1..{TRAIN_STEPS} then a resume to {TRAIN_STEPS + RESUME_STEPS}, "
                             f"got {[s['step'] for s in steps]}")
    for s in steps:
        if s["launches"] != expected:
            raise AssertionError(f"step {s['step']}: launches {s['launches']}, expected {expected}")
        if s["routes"] != on_tensor_cores:
            raise AssertionError(f"step {s['step']}: launches by route {s['routes']}, expected all on the tensor cores")
        if not (math.isfinite(s["total_loss"]) and math.isfinite(s["grad_norm"]) and s["grad_nonfinite"] == 0
                and s["grad_norm/encoder"] > 0 and s["grad_norm/denoiser"] > 0):
            raise AssertionError(f"step {s['step']}: bad loss or gradient norms {s}")
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


def kernel_line(errs: dict, rows: list[dict], sweep: list[dict], serve: tuple, train: tuple, heldout: tuple) -> dict:
    """The kernels' JSON line; ``serve`` and ``train`` are (launches,
    launches by route, seconds per request or per steady step), ``heldout``
    (launches, launches by route, the accuracy phase's result)."""
    from diffassemble_tpu_torch import REFERENCE_PACKAGE
    from diffassemble_tpu_torch.ops import cuda_attention

    (serve_counts, serve_routes, request_seconds), (train_counts, train_routes, step_seconds) = serve, train
    eval_counts, eval_routes, eval_result = heldout
    out = []
    for kernel, source in KERNEL_SOURCES.items():
        # the forward kernel's figures are per denoiser step at the serving
        # shapes (B = 1); the backward kernels' per train step (B = 8)
        b = 1 if kernel == "masked_attention_fwd" else TRAIN_BATCH
        per = [r for r in rows if r["kernel"] == kernel and r["b"] == b and r["main_path"]]
        step = {key: sum(r[key] * r["launches_per_step"] for r in per)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        out.append({
            "name": kernel,
            "route": "cuda",
            "source": source,
            "sources_by_route": {"tensor_cores": source, "cuda_cores": CUDA_CORE_SOURCES[kernel]},
            "replaces": f"{REFERENCE_PACKAGE}/{cuda_attention.REPLACES[kernel]}",
            "launches": serve_counts[kernel] + train_counts[kernel] + eval_counts[kernel],
            "launches_by_path": {"serve": serve_counts[kernel], "train": train_counts[kernel],
                                 "heldout_eval": eval_counts[kernel]},
            "launches_by_route": {"serve": serve_routes[kernel], "train": train_routes[kernel],
                                  "heldout_eval": eval_routes[kernel]},
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
    out[0]["seconds_per_request"] = request_seconds
    out[1]["seconds_per_train_step"] = step_seconds
    out[0]["heldout_eval"] = eval_result
    return {"kernels": out}


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--profile", nargs="?", const="serve", choices=["serve", "train", "eval"],
                    help="instead of the smoke run, profile one serving request (default), one train step "
                         "or one held-out call of 32 puzzles with the trained weights")
    args = ap.parse_args()

    smi, name, count = environment()
    build()
    if args.profile:
        {"serve": profile_request, "train": profile_train_step, "eval": profile_heldout_call}[args.profile]()
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
    if (serve[0]["masked_attention_fwd"] == 0 or any(v == 0 for v in train[0].values())
            or heldout[0]["masked_attention_fwd"] == 0):
        raise AssertionError(f"a kernel of a main path was not launched: serve {serve[0]}, train {train[0]}, "
                             f"held-out eval {heldout[0]}")
    line = kernel_line(errs, rows, sweep, serve, train, heldout)
    phase("done")
    print(smi, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
