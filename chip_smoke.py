#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diffassemble_tpu_torch``) on one GPU.

    python3 chip_smoke.py              # the smoke run
    python3 chip_smoke.py --profile    # one serving request under torch.profiler

Phases, each ending in a line with the elapsed seconds:

1. environment: the card's name and power limit (nvidia-smi), device count;
2. build: the masked-attention kernel from ``csrc/`` with nvcc (-Xptxas -v);
3. kernel against its plain PyTorch version on the card: expander + virtual
   nodes, fully connected, padded empty rows, and N = 200, at head widths 32
   and 144, in bf16 and f32; then the kernel, plain and
   ``scaled_dot_product_attention`` times at the serving shapes;
4. the slice: the flagship 30×30 rotation config from
   ``weights/diffusion2d_rot30/config.json`` (JSON only) with seeded weights;
   one denoiser call with the kernel against the same call with plain
   attention; a 6×6 sample on the card against the same model on the CPU;
   then ``PuzzleSolver.predict_array`` on 3 seeded 960×960 images, counting
   the kernel's launches (4 layers × 30 steps per request).

The last three lines are the nvidia-smi line, a JSON object describing the
kernel, and ``{"ok": true, "device": {...}}``. Any failure raises, and the
script exits non-zero without printing the last line.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "weights" / "diffusion2d_rot30" / "config.json"
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, NVIDIA H100 SXM data sheet
H100_F32_FLOPS = 67e12  # non-tensor-core f32 peak
H100_BYTES_PER_S = 3.35e12
SERVE_N = 908  # 900 pieces + 8 virtual nodes
SERVE_HEADS = 8
SERVE_STEP_LAUNCHES = ((32, 3), (144, 1))  # (head width, launches) per denoiser step
REQUESTS = 3

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


def attention_bound_ms(b: int, n: int, h: int, dh: int, elem_bytes: int) -> tuple[float, str]:
    """Least time on an H100 for one forward: the larger of operations over
    the peak rate for the type and bytes (q, k, v, O, L once, mask once) over
    the memory rate."""
    flops = 4.0 * b * h * n * n * dh
    nbytes = 4.0 * b * n * h * dh * elem_bytes + b * n * n + 4.0 * b * h * n
    t_ops = flops / (H100_BF16_FLOPS if elem_bytes == 2 else H100_F32_FLOPS)
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    phase(f"environment: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"device {name} | count {count}")
    return smi, name, count


def build() -> None:
    from diffassemble_tpu_torch.ops import cuda_attention

    lib = cuda_attention.load_library()
    for line in lib.compiler_log.splitlines():
        if "ptxas" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    phase(f"build: {lib.path.name} in {lib.build_seconds:.2f} s")


def _masks(torch, np):
    """(label, mask (B, N, N) bool on the card) for each checked topology."""
    from diffassemble_tpu_torch.data.expander import expander_mask
    from diffassemble_tpu_torch.ops.attention import (
        build_adjacency_mask,
        extend_mask_with_virtual_nodes,
    )

    rng = np.random.default_rng(0)
    topo = torch.as_tensor(expander_mask(900, "10%", rng))
    all_valid = torch.ones((2, 900), dtype=torch.bool)
    padded = all_valid.clone()
    padded[1, 850:] = False  # 50 padded pieces: their rows and columns are empty
    out = []
    for label, node_mask in (("expander10%+8virt", all_valid), ("expander10%+8virt, 50 padded", padded)):
        adj, _ = extend_mask_with_virtual_nodes(build_adjacency_mask(topo, node_mask), node_mask, 8)
        if label.endswith("padded"):
            adj[0, 700:720] = False  # plus rows with no edges at all in the first graph
        out.append((label, adj))
    out.append(("fully connected", torch.ones((2, SERVE_N, SERVE_N), dtype=torch.bool)))
    small_valid = torch.ones((2, 200), dtype=torch.bool)
    small_valid[1, 150:] = False
    small = build_adjacency_mask(torch.as_tensor(rng.random((2, 200, 200)) < 0.3), small_valid)
    out.append(("N=200, random 30%, 50 padded", small))
    return [(label, m.cuda().contiguous()) for label, m in out]


def kernel_vs_plain() -> dict:
    import numpy as np
    import torch

    from diffassemble_tpu_torch.ops.cuda_attention import (
        masked_attention_fwd,
        masked_attention_fwd_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for label, mask in _masks(torch, np):
        b, n, _ = mask.shape
        empty = ~mask.any(-1)  # (B, N)
        for dh in (32, 144):
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = (torch.randn((b, n, SERVE_HEADS, dh), generator=gen, device="cuda").to(dtype)
                           for _ in range(3))
                o, lse = masked_attention_fwd(q, k, v, mask)
                torch.cuda.synchronize()
                o_p, lse_p = masked_attention_fwd_plain(q, k, v, mask)
                torch.cuda.synchronize()
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
                nonempty = ~empty[:, None, :].expand(b, SERVE_HEADS, n)
                lse_err = (lse - lse_p).abs()[nonempty]
                ok = (
                    bool(torch.isfinite(of).all()) and bool(torch.isfinite(lse).all())
                    and bool((err <= tol).all())
                    and bool((lse_err <= 1e-5 * (1 + lse_p.abs()[nonempty])).all())
                    and bool((of[empty] == 0).all())
                    and torch.equal(lse[~nonempty], lse_p[~nonempty])
                )
                max_err = max(max_err, err.max().item())
                phase(f"kernel vs plain: {label:32s} N={n} Dh={dh:3d} {str(dtype)[6:]:8s} "
                      f"max|dO|={err.max().item():.3e} max|dL|={lse_err.max().item():.3e} "
                      f"empty rows={int(empty.sum())} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with its plain version: {label} Dh={dh} {dtype}")

    # times at the serving shapes: one puzzle, fully connected, bf16
    per_shape = []
    mask = torch.ones((1, SERVE_N, SERVE_N), dtype=torch.bool, device="cuda")
    for dh, count in SERVE_STEP_LAUNCHES:
        q, k, v = (torch.randn((1, SERVE_N, SERVE_HEADS, dh), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa_mask = mask[:, None]
        ms = cuda_ms(lambda: masked_attention_fwd(q, k, v, mask))
        plain_ms = cuda_ms(lambda: masked_attention_fwd_plain(q, k, v, mask))
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask))
        bound, bound_by = attention_bound_ms(1, SERVE_N, SERVE_HEADS, dh, 2)
        per_shape.append({"dh": dh, "launches_per_step": count, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by})
        phase(f"timing B=1 N={SERVE_N} H={SERVE_HEADS} Dh={dh} bf16: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound:.5f} ms ({bound_by})")
    return {"max_abs_err": max_err, "per_shape": per_shape}


def the_slice() -> tuple[int, list[float]]:
    import dataclasses

    import numpy as np
    import torch

    from diffassemble_tpu_torch.cli.serve import PuzzleSolver
    from diffassemble_tpu_torch.data import collate_puzzles, make_puzzle
    from diffassemble_tpu_torch.models import Diffusion2D, Diffusion2DConfig
    from diffassemble_tpu_torch.ops import attention
    from diffassemble_tpu_torch.ops.cuda_attention import (
        masked_attention_fwd,
        masked_attention_fwd_plain,
    )

    cfg = Diffusion2DConfig(**json.loads(CONFIG.read_text()))
    rng = np.random.default_rng(0)

    def puzzle(n: int, device: str):
        s = make_puzzle(rng.random((n * 32, n * 32, 3)).astype(np.float32), n, n, 32,
                        rotation=cfg.rotation, rng=rng)
        return collate_puzzles([s], n * n).to(device)

    # one denoiser call: kernel attention against plain attention, bf16 and f32
    batch = puzzle(30, "cuda")
    for dtype_name, rel_tol in (("float32", 1e-4), ("bfloat16", 5e-2)):
        model = Diffusion2D(dataclasses.replace(cfg, compute_dtype=dtype_name), device="cuda", seed=0)
        with torch.no_grad():
            feats = model.visual_features(batch.patches)
            x_t = torch.randn(batch.x0.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                              device="cuda")
            t = torch.full(x_t.shape[:2], 290, dtype=torch.int32, device="cuda")
            out_k = model.denoise(x_t, t, feats, batch.adj, batch.node_mask)
            with mock.patch.object(attention, "masked_attention_fwd", masked_attention_fwd_plain):
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
    small = puzzle(6, "cpu")
    final_cpu = Diffusion2D(small_cfg, device="cpu", seed=0).sample(small).final
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
    masked_attention_fwd.launches = 0
    for img in images:
        start, before = time.perf_counter(), masked_attention_fwd.launches
        out = solver.predict_array(img)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        launched = masked_attention_fwd.launches - before
        phase(f"request: {seconds[-1]:.3f} s, kernel launches {launched}, output {out.shape}")
        if launched != cfg.n_layers * (cfg.steps // cfg.inference_ratio):
            raise AssertionError(f"expected {cfg.n_layers}×{cfg.steps // cfg.inference_ratio} launches")
        if out.shape != (960, 960, 3) or not np.isfinite(out).all():
            raise AssertionError("bad output image")
    launches = masked_attention_fwd.launches
    phase(f"served {REQUESTS} requests: {launches} launches, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    final = solver.model.sample(batch, torch.Generator(device="cuda").manual_seed(2)).final
    metrics = solver.model.metrics_from_final(final, batch)
    if not all(torch.isfinite(m.float()).all() for m in metrics.values()):
        raise AssertionError("non-finite metrics")
    phase(f"metrics_from_final (random weights): piece_acc {metrics['piece_acc'].tolist()}")
    return launches, seconds


def _family(kernel_name: str) -> str:
    name = kernel_name.lower()
    for family, keys in (("masked_attention_fwd (this port)", ("masked_attention_fwd",)),
                         ("matmul", ("gemm", "cutlass", "xmma", "sm90", "nvjet")),
                         ("convolution", ("conv", "cudnn", "winograd", "implicit")),
                         ("reduction", ("reduce", "norm", "softmax")),
                         ("elementwise", ("elementwise", "vectorized", "unrolled"))):
        if any(k in name for k in keys):
            return family
    return "other"


def profile_request() -> None:
    """One serving request (after one warm-up) under torch.profiler: wall
    time, device time by kernel family and the device's idle share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffassemble_tpu_torch.cli.serve import PuzzleSolver
    from diffassemble_tpu_torch.models import Diffusion2DConfig

    cfg = Diffusion2DConfig(**json.loads(CONFIG.read_text()))
    solver = PuzzleSolver(cfg, seed=0, device="cuda", puzzle_size=30)
    img = np.random.default_rng(100).random((960, 960, 3)).astype(np.float32)
    solver.predict_array(img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        solver.predict_array(img)
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
        phase(f"profile: request {wall_ms:.2f} ms wall; device time not measured (the trace holds none)")
        return
    launches = sum(int(f[1]) for f in families.values())
    phase(f"profile: request {wall_ms:.2f} ms wall, {device_ms:.2f} ms in {launches} device kernels, "
          f"device idle share {1 - device_ms / wall_ms:.3f} (one stream: kernels do not overlap)")
    for fam, (ms, calls) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        phase(f"profile:   {fam:34s} {ms:9.3f} ms  {calls:6d} launches  {ms / device_ms:.3f} of device time")
    for ms, calls, key in sorted(kernels, reverse=True)[:12]:
        phase(f"profile:     {ms:9.3f} ms {calls:6d}x  {key[:100]}")


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="instead of the smoke run, profile one serving request")
    args = ap.parse_args()

    from diffassemble_tpu_torch import REFERENCE_PACKAGE
    from diffassemble_tpu_torch.ops import cuda_attention

    smi, name, count = environment()
    build()
    if args.profile:
        profile_request()
        print(smi, flush=True)
        return
    kern = kernel_vs_plain()
    launches, seconds = the_slice()
    per = kern["per_shape"]
    step = {key: sum(p[key] * p["launches_per_step"] for p in per)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    bound_by = "operations" if all(p["bound_by"] == "operations" for p in per) else "bytes"
    kernels = {"kernels": [{
        "name": "masked_attention_fwd",
        "route": "cuda",
        "source": "diffassemble_tpu_torch/csrc/masked_attention_fwd.cu",
        "replaces": f"{REFERENCE_PACKAGE}/{cuda_attention.REPLACES}",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": step["ms"],
        "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"],
        "bound_by": bound_by,
        "library_ms": step["library_ms"],
        "times_are_for": "one denoiser step: 3 launches at Dh=32 and 1 at Dh=144, B=1, H=8, N=908, bf16",
        "per_shape": per,
        "seconds_per_request": seconds,
    }]}
    phase("done")
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
