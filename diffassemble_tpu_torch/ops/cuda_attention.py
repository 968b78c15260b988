"""Host side of the hand-written CUDA masked-attention kernels.

Five kernels replace the three TPU kernels of the JAX package's
``ops/pallas_attention.py``:

- ``masked_attention_fwd`` replaces ``_attn_kernel`` (launched by
  ``_flash_fwd``), by two kernels: one for every graph size, and
  ``masked_attention_fwd_small`` for graphs of at most ``SMALL_GRAPH_N`` (32)
  nodes, a head's whole graph in one block;
- ``masked_attention_bwd_dq`` replaces ``_bwd_dq_kernel`` and
  ``masked_attention_bwd_dkv`` replaces ``_bwd_dkv_kernel`` (both launched by
  ``_flash_bwd``);
- ``masked_attention_bwd_small`` replaces both backward kernels at once on
  graphs of at most ``SMALL_GRAPH_N`` nodes: dQ, dK and dV in one launch,
  with Δ computed in the block.

Each takes every head width from 1 to ``MAX_HEAD_DIM`` (288) in float32 and
bfloat16, by one of three routes, which ``route`` names and ``_launch``
dispatches by type, width, alignment and graph size:

- the tensor-core route (``"tensor_cores"``): ``csrc/masked_attention_fwd_tc.cu``
  (the forward) and ``csrc/masked_attention_bwd_tc.cu`` (dQ and dK/dV), on
  ``mma.sync`` with bf16 operands and f32 accumulators, for bfloat16 at the
  widths in ``TENSOR_CORE_HEAD_DIMS`` (32 and 144, the main paths'), whose
  base pointers are 16-byte aligned (as every fresh allocation is), at any
  graph size; and for float32 ``csrc/masked_attention_fwd_tc_f32.cu`` (the
  forward) and ``csrc/masked_attention_bwd_tc_f32.cu`` (dQ and dK/dV), on
  ``mma.sync`` with TF32 operands, each product taken three times over the
  operands' hi and lo TF32 halves (3xTF32, about f32 accuracy), at the same
  widths and alignment on graphs of more than ``SMALL_GRAPH_N`` nodes; all
  four include the device helpers of ``csrc/tc_common.cuh``;
- the small-graph route (``"small_graph"``), a graph of at most
  ``SMALL_GRAPH_N`` nodes off the tensor-core route, in f32 on the CUDA
  cores, one block holding a head's whole graph: the forward
  ``csrc/masked_attention_fwd_small.cu`` and the fused backward
  ``csrc/masked_attention_bwd_small.cu``. There ``masked_attention_bwd_dq``
  and ``_dkv`` raise on CUDA tensors: the backward is
  ``masked_attention_bwd_small``'s;
- the CUDA-core route (``"cuda_cores"``), larger graphs off the tensor-core
  route: ``csrc/masked_attention_fwd.cu`` and ``csrc/masked_attention_bwd.cu``,
  products in f32 on the CUDA cores, templated on the number of 32-column
  slots (1 to 9) and given the width at run time (32 and 144 are also
  compiled in), for every other width and inputs off a 16-byte boundary.

Every route is a hand-written kernel, held against the same plain versions
(``masked_attention_bwd_small_plain`` equals the dQ and dK/dV plain versions
bit for bit).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (one ``nvcc`` per source, run in
parallel), cached under ``diffassemble_tpu_torch/_build/`` by the hash of the
source and the headers, and loaded with ``ctypes``.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute, by route in ``launches_by_route`` and by the C
function launched (``c_function``) in ``launches_by_function``; for CPU
tensors it computes the kernel's plain PyTorch version (``*_plain``). There
is no fall back from the card to the plain version, nor from one route to
another. ``MaskedAttention`` is the autograd ``Function`` over the wrappers:
the forward, then on the small-graph route the fused backward, else Δ =
rowsum(dO∘O) and the two backward kernels (the JAX package's ``custom_vjp``
of ``flash_masked_attention``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES = {
    "fwd": _PKG / "csrc" / "masked_attention_fwd.cu",
    "bwd": _PKG / "csrc" / "masked_attention_bwd.cu",
    "bwd_tc": _PKG / "csrc" / "masked_attention_bwd_tc.cu",
    "fwd_tc": _PKG / "csrc" / "masked_attention_fwd_tc.cu",
    "bwd_small": _PKG / "csrc" / "masked_attention_bwd_small.cu",
    "fwd_small": _PKG / "csrc" / "masked_attention_fwd_small.cu",
    "bwd_tc_f32": _PKG / "csrc" / "masked_attention_bwd_tc_f32.cu",
    "fwd_tc_f32": _PKG / "csrc" / "masked_attention_fwd_tc_f32.cu",
}
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))  # included by the sources; part of each hash
BUILD_DIR = _PKG / "_build"
# the TPU kernels each one replaces, in the JAX package (REFERENCE_PACKAGE)
REPLACES = {
    "masked_attention_fwd": ("ops/pallas_attention.py:62",),
    "masked_attention_bwd_dq": ("ops/pallas_attention.py:94",),
    "masked_attention_bwd_dkv": ("ops/pallas_attention.py:121",),
    "masked_attention_bwd_small": ("ops/pallas_attention.py:94", "ops/pallas_attention.py:121"),
}
MAX_HEAD_DIM = 288  # the widest head the kernels take (9 slots of 32 columns)
# the kernels with a tensor-core route (bfloat16 at any graph size, float32 on
# more than SMALL_GRAPH_N nodes), and its head widths
TENSOR_CORE_KERNELS = ("masked_attention_fwd", "masked_attention_bwd_dq", "masked_attention_bwd_dkv")
ROUTES = ("tensor_cores", "cuda_cores", "small_graph")
TENSOR_CORE_HEAD_DIMS = (32, 144)
# a graph of at most SMALL_GRAPH_N nodes off the tensor-core route takes the
# small-graph kernels (a block holds the whole graph): the forward's, and for
# the backward pair the fused kernel's
SMALL_GRAPH_N = 32
BACKWARD_PAIR = ("masked_attention_bwd_dq", "masked_attention_bwd_dkv")
SMALL_GRAPH_KERNELS = ("masked_attention_fwd", *BACKWARD_PAIR)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e9
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 300
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {  # C function → (library, argtypes)
    "masked_attention_fwd": ("fwd", [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P]),
    "masked_attention_bwd_dq": ("bwd", [_P] * 8 + [_I] * 5 + [ctypes.c_float, _P]),
    "masked_attention_bwd_dkv": ("bwd", [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P]),
    "masked_attention_bwd_dq_tc": ("bwd_tc", [_P] * 8 + [_I] * 5 + [ctypes.c_float, _P]),
    "masked_attention_bwd_dkv_tc": ("bwd_tc", [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P]),
    "masked_attention_fwd_tc": ("fwd_tc", [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P]),
    # the forward with its block's query rows given (64, 32 or 16), and the
    # rows masked_attention_fwd_tc chooses for (batch, n, heads, head_dim): chip_smoke.py times each
    "masked_attention_fwd_tc_rows": ("fwd_tc", [_P] * 6 + [_I] * 5 + [ctypes.c_float, _I, _P]),
    "masked_attention_fwd_tc_block_rows": ("fwd_tc", [_I] * 4),
    "masked_attention_bwd_small": ("bwd_small", [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P]),
    "masked_attention_fwd_small": ("fwd_small", [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P]),
    "masked_attention_bwd_dq_tc_f32": ("bwd_tc_f32", [_P] * 8 + [_I] * 5 + [ctypes.c_float, _P]),
    "masked_attention_bwd_dkv_tc_f32": ("bwd_tc_f32", [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P]),
    "masked_attention_fwd_tc_f32": ("fwd_tc_f32", [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P]),
}


@dataclasses.dataclass
class KernelLibrary:
    """The loaded shared libraries and how they were built."""

    libs: dict[str, ctypes.CDLL]  # by SOURCES key
    paths: dict[str, Path]
    build_seconds: float  # wall time of the parallel build; 0.0 when all were built
    compiler_log: str  # nvcc's output for every library, built now or before, with the -Xptxas -v lines

    def fn(self, name: str):
        return getattr(self.libs[_SIGNATURES[name][0]], name)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the attention kernels")


def _library_path(key: str) -> Path:
    text = b"".join(p.read_bytes() for p in (SOURCES[key], *HEADERS)) + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{SOURCES[key].stem}-{digest}.so"


def _compile(key: str, out: Path) -> None:
    """One nvcc run: ``SOURCES[key]`` → ``out``, its output kept beside it
    (``.log``, written first: a library on disk has its build report)."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[key])]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"{SOURCES[key].name}: nvcc failed\n{log}")
    tmp_log = out.with_suffix(f".{os.getpid()}.log")
    tmp_log.write_text(f"== {SOURCES[key].name}\n{log}")
    os.replace(tmp_log, out.with_suffix(".log"))
    os.replace(tmp, out)


@functools.cache
def load_library() -> KernelLibrary:
    """Build the kernel libraries (once per source hash, kept in ``BUILD_DIR``;
    one nvcc per source, all started together) and load them, once per
    process: launches pay no hashing or file access."""
    paths = {key: _library_path(key) for key in SOURCES}
    todo = {key: p for key, p in paths.items() if not p.exists()}
    seconds = 0.0
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        start = time.perf_counter()
        with ThreadPoolExecutor(len(todo)) as pool:
            list(pool.map(_compile, todo, todo.values()))
        seconds = time.perf_counter() - start
    logs = (p.with_suffix(".log") for p in paths.values())
    log = "".join(p.read_text() for p in logs if p.exists())
    libs = {key: ctypes.CDLL(str(p)) for key, p in paths.items()}
    for name, (key, argtypes) in _SIGNATURES.items():
        fn = getattr(libs[key], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(libs, paths, seconds, log)


# ------------------------------------------------------------ plain versions


def masked_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel (the Pallas ``_attn_kernel``'s math).

    q, k, v (B, N, H, Dh); mask (B, N, N) bool or int8. Returns O (B, N, H, Dh)
    in q's type and L (B, H, N) f32. Scores and softmax in f32; the normalised
    probabilities are rounded to v's type before the product with v, which
    accumulates in f32.
    """
    dh = q.shape[-1]
    m = mask.bool()[:, None]  # (B, 1, N, N)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * (1.0 / math.sqrt(dh))
    s = torch.where(m, s, _NEG_INF)
    smax = s.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(s - smax) * m
    denom = unnorm.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    probs = (unnorm / denom).to(v.dtype).float()
    o = torch.einsum("bhnm,bmhd->bnhd", probs, v.float()).to(q.dtype)
    lse = (smax + torch.log(denom))[..., 0]
    return o, lse


def _bwd_plain_parts(q, k, v, mask, dout, lse, delta):
    """P and dS (B, H, N, N) f32 of the backward: P = exp(S − L) on edges
    (a masked entry is never exponentiated), dS = P∘(dO·vᵀ − Δ)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    m = mask.bool()[:, None]
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = torch.exp(torch.where(m, s - lse[..., None], -math.inf))
    dp = torch.einsum("bnhd,bmhd->bhnm", dout.float(), v.float())
    return p, p * (dp - delta[..., None]), scale


def masked_attention_bwd_dq_plain(q, k, v, mask, dout, lse, delta) -> torch.Tensor:
    """Plain PyTorch version of the dQ kernel (the Pallas ``_bwd_dq_kernel``'s
    math, with P taken from L): dQ = (P∘(dO·vᵀ − Δ))·k/√Dh in f32, returned
    in q's type. q, k, v, dout (B, N, H, Dh); lse, delta (B, H, N) f32."""
    _, ds, scale = _bwd_plain_parts(q, k, v, mask, dout, lse, delta)
    return (torch.einsum("bhnm,bmhd->bnhd", ds, k.float()) * scale).to(q.dtype)


def masked_attention_bwd_dkv_plain(q, k, v, mask, dout, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dK/dV kernel (the Pallas ``_bwd_dkv_kernel``'s
    math): dV = Pᵀ·dO, dK = (P∘(dO·vᵀ − Δ))ᵀ·q/√Dh in f32, returned in the
    inputs' type."""
    p, ds, scale = _bwd_plain_parts(q, k, v, mask, dout, lse, delta)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q.float()) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(dout: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO∘O) in f32, (B, N, H, Dh) → (B, H, N) contiguous."""
    return (dout.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def masked_attention_bwd_small_plain(q, k, v, mask, dout, o, lse) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused small-graph kernel (the Pallas
    ``_bwd_dq_kernel``'s and ``_bwd_dkv_kernel``'s math together): Δ from
    ``attention_delta``, then P and dS once; dQ, dK and dV in the inputs'
    type, equal bit for bit to ``masked_attention_bwd_dq_plain`` and
    ``masked_attention_bwd_dkv_plain`` with that Δ. q, k, v, dout, o (B, N,
    H, Dh); lse (B, H, N) f32."""
    p, ds, scale = _bwd_plain_parts(q, k, v, mask, dout, lse, attention_delta(dout, o))
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k.float()) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q.float()) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ wrappers


def _check(q, k, v, mask, dout=None, lse=None, delta=None, o=None):
    """Shapes, types, device and contiguity the kernels take: q, k, v, dO and
    O (B, N, H, Dh) alike, the mask (B, N, N), L and Δ (B, H, N) f32."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, N, H, Dh), got {tuple(q.shape)}")
    b, n, h, dh = q.shape
    like_q = {"k": k, "v": v, "dout": dout, "o": o}
    rows = {"lse": lse, "delta": delta}
    for name, t in like_q.items():
        if t is not None and (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not match q")
    for name, t in rows.items():
        if t is not None and (t.shape != (b, h, n) or t.dtype != torch.float32 or t.device != q.device):
            raise ValueError(f"{name} must be (B, H, N) float32 on {q.device}, got {tuple(t.shape)} {t.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"the kernels take head widths 1 to {MAX_HEAD_DIM}, got {dh} "
                         "(wider heads: ROADMAP Queue 2, K3)")
    if mask.shape != (b, n, n) or mask.dtype not in (torch.bool, torch.int8) or mask.device != q.device:
        raise ValueError(f"mask must be (B, N, N) bool/int8 on {q.device}, got {tuple(mask.shape)} {mask.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, mask, dout, lse, delta, o) if t is not None):
        raise ValueError("the kernels' inputs must be contiguous")


def route(name: str, *tensors: torch.Tensor) -> str:
    """The route kernel ``name`` takes for ``tensors`` (q first):
    ``"tensor_cores"`` for a kernel in ``TENSOR_CORE_KERNELS`` at a width in
    ``TENSOR_CORE_HEAD_DIMS`` with every base pointer 16-byte aligned, in
    bfloat16 (any graph size) and in float32 (3xTF32) on more than
    ``SMALL_GRAPH_N`` nodes; else ``"small_graph"`` for the fused backward,
    and for the forward and the backward pair (``SMALL_GRAPH_KERNELS``) on
    at most ``SMALL_GRAPH_N`` nodes (the backward pair's is the fused
    kernel's); else ``"cuda_cores"``."""
    q = tensors[0]
    if name in TENSOR_CORE_KERNELS and q.shape[-1] in TENSOR_CORE_HEAD_DIMS and (
            q.dtype == torch.bfloat16 or (q.dtype == torch.float32 and q.shape[1] > SMALL_GRAPH_N)) \
            and all(t.data_ptr() % 16 == 0 for t in tensors):
        return "tensor_cores"
    if name == "masked_attention_bwd_small" or (name in SMALL_GRAPH_KERNELS and q.shape[1] <= SMALL_GRAPH_N):
        return "small_graph"
    return "cuda_cores"


def c_function(name: str, way: str, dtype: torch.dtype) -> str:
    """The C function that kernel ``name`` launches on route ``way`` for
    inputs of ``dtype``: on the tensor cores ``*_tc`` (bfloat16) or
    ``*_tc_f32`` (float32), the forward on the
    small-graph route ``masked_attention_fwd_small``, else ``name`` itself."""
    if way == "tensor_cores":
        return name + ("_tc" if dtype == torch.bfloat16 else "_tc_f32")
    if way == "small_graph" and name == "masked_attention_fwd":
        return "masked_attention_fwd_small"
    return name


def _launch(name: str, *tensors: torch.Tensor) -> tuple[str, str]:
    """Call kernel ``name`` on ``tensors`` (inputs then outputs, all on one
    card) with q's shape, on the current stream, by its ``route``; raise on a
    CUDA error. Returns the route and the C function launched."""
    q = tensors[0]
    b, n, h, dh = q.shape
    way = route(name, *tensors)
    if way == "small_graph" and name in BACKWARD_PAIR:
        raise ValueError(f"{name}: the backward of a graph of at most {SMALL_GRAPH_N} nodes off the tensor cores "
                         "is masked_attention_bwd_small's")
    c_name = c_function(name, way, q.dtype)
    rc = load_library().fn(c_name)(
        *(t.data_ptr() for t in tensors), b, n, h, dh, _DTYPES[q.dtype], 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{c_name} launch failed: CUDA error {rc}")
    return way, c_name


def _count(kernel, launched: tuple[str, str]) -> None:
    way, c_name = launched
    kernel.launches += 1
    kernel.launches_by_route[way] += 1
    kernel.launches_by_function[c_name] = kernel.launches_by_function.get(c_name, 0) + 1


def masked_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused masked attention forward: O (B, N, H, Dh) and L (B, H, N) f32.

    CUDA tensors launch the kernel of their ``route`` on the current stream
    (on the small-graph route ``masked_attention_fwd_small``); CPU tensors
    use ``masked_attention_fwd_plain``.
    """
    if not q.is_cuda:
        return masked_attention_fwd_plain(q, k, v, mask)
    _check(q, k, v, mask)
    b, n, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _count(masked_attention_fwd, _launch("masked_attention_fwd", q, k, v, mask, o, lse))
    return o, lse


def masked_attention_bwd_dq(q, k, v, mask, dout, lse, delta) -> torch.Tensor:
    """dQ (B, N, H, Dh) in q's type from the forward's inputs, dO, L and Δ.

    CUDA tensors launch the kernel on the current stream; CPU tensors use
    ``masked_attention_bwd_dq_plain``.
    """
    if not q.is_cuda:
        return masked_attention_bwd_dq_plain(q, k, v, mask, dout, lse, delta)
    _check(q, k, v, mask, dout, lse, delta)
    dq = torch.empty_like(q)
    _count(masked_attention_bwd_dq, _launch("masked_attention_bwd_dq", q, k, v, mask, dout, lse, delta, dq))
    return dq


def masked_attention_bwd_dkv(q, k, v, mask, dout, lse, delta) -> tuple[torch.Tensor, torch.Tensor]:
    """dK, dV (B, N, H, Dh) in the inputs' type from the forward's inputs, dO, L and Δ.

    CUDA tensors launch the kernel on the current stream; CPU tensors use
    ``masked_attention_bwd_dkv_plain``.
    """
    if not q.is_cuda:
        return masked_attention_bwd_dkv_plain(q, k, v, mask, dout, lse, delta)
    _check(q, k, v, mask, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _count(masked_attention_bwd_dkv, _launch("masked_attention_bwd_dkv", q, k, v, mask, dout, lse, delta, dk, dv))
    return dk, dv


def masked_attention_bwd_small(q, k, v, mask, dout, o, lse) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV (B, N, H, Dh) in the inputs' type from the forward's inputs,
    dO, O and L, on a graph of at most ``SMALL_GRAPH_N`` nodes: one launch,
    Δ computed in it.

    CUDA tensors launch the kernel on the current stream; CPU tensors use
    ``masked_attention_bwd_small_plain``.
    """
    if not q.is_cuda:
        return masked_attention_bwd_small_plain(q, k, v, mask, dout, o, lse)
    _check(q, k, v, mask, dout, lse, o=o)
    if q.shape[1] > SMALL_GRAPH_N:
        raise ValueError(f"masked_attention_bwd_small takes graphs of at most {SMALL_GRAPH_N} nodes, "
                         f"got {q.shape[1]}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _count(masked_attention_bwd_small,
           _launch("masked_attention_bwd_small", q, k, v, mask, dout, o, lse, dq, dk, dv))
    return dq, dk, dv


KERNELS = (masked_attention_fwd, masked_attention_bwd_dq, masked_attention_bwd_dkv, masked_attention_bwd_small)


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` and ``launches_by_route`` to 0, and
    empty its ``launches_by_function``."""
    for kernel in KERNELS:
        kernel.launches = 0
        kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
        kernel.launches_by_function = {}


reset_launch_counts()


class MaskedAttention(torch.autograd.Function):
    """Masked attention (B, N, H, Dh) × (B, N, N) → (B, N, H, Dh) whose
    forward and backward are the kernels above (the JAX package's
    ``custom_vjp`` of ``flash_masked_attention``): the backward is the fused
    kernel's where ``route`` says ``"small_graph"``, one launch, else Δ and
    the dQ and dK/dV kernels. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        o, lse = masked_attention_fwd(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, mask, o, lse = ctx.saved_tensors
        dout = grad_out.contiguous()
        if route(BACKWARD_PAIR[0], q, k, v, mask, dout, lse) == "small_graph":
            return (*masked_attention_bwd_small(q, k, v, mask, dout, o, lse), None)
        delta = attention_delta(dout, o)
        dq = masked_attention_bwd_dq(q, k, v, mask, dout, lse, delta)
        dk, dv = masked_attention_bwd_dkv(q, k, v, mask, dout, lse, delta)
        return dq, dk, dv, None
