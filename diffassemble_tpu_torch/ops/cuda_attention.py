"""Host side of the hand-written CUDA masked-attention kernels.

Three kernels replace the three TPU kernels of the JAX package's
``ops/pallas_attention.py``:

- ``csrc/masked_attention_fwd.cu``: ``masked_attention_fwd`` replaces
  ``_attn_kernel`` (launched by ``_flash_fwd``);
- ``csrc/masked_attention_bwd.cu``: ``masked_attention_bwd_dq`` replaces
  ``_bwd_dq_kernel`` and ``masked_attention_bwd_dkv`` replaces
  ``_bwd_dkv_kernel`` (both launched by ``_flash_bwd``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (one ``nvcc`` per source, run in
parallel), cached under ``diffassemble_tpu_torch/_build/`` by the source's
hash, and loaded with ``ctypes``.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it computes the kernel's plain
PyTorch version (``*_plain``). There is no fall back from the card to the
plain version. ``MaskedAttention`` is the autograd ``Function`` over the
three: the forward kernel, then Δ = rowsum(dO∘O) and the two backward kernels
(the JAX package's ``custom_vjp`` of ``flash_masked_attention``).
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
}
BUILD_DIR = _PKG / "_build"
# the TPU kernel each one replaces, in the JAX package (REFERENCE_PACKAGE)
REPLACES = {
    "masked_attention_fwd": "ops/pallas_attention.py:62",
    "masked_attention_bwd_dq": "ops/pallas_attention.py:94",
    "masked_attention_bwd_dkv": "ops/pallas_attention.py:121",
}
HEAD_DIMS = (32, 144)  # head widths the kernels are instantiated for
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
}


@dataclasses.dataclass
class KernelLibrary:
    """The loaded shared libraries and how they were built."""

    libs: dict[str, ctypes.CDLL]  # by SOURCES key
    paths: dict[str, Path]
    build_seconds: float  # wall time of the parallel build; 0.0 when all were built
    compiler_log: str  # nvcc's output, including the -Xptxas -v lines

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
    digest = hashlib.sha256(SOURCES[key].read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{SOURCES[key].stem}-{digest}.so"


def _compile(key: str, out: Path) -> str:
    """One nvcc run: ``SOURCES[key]`` → ``out``; returns nvcc's output."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[key])]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"{SOURCES[key].name}: nvcc failed\n{log}")
    os.replace(tmp, out)
    return f"== {SOURCES[key].name}\n{log}"


@functools.cache
def load_library() -> KernelLibrary:
    """Build the kernel libraries (once per source hash, kept in ``BUILD_DIR``;
    one nvcc per source, all started together) and load them, once per
    process: launches pay no hashing or file access."""
    paths = {key: _library_path(key) for key in SOURCES}
    todo = {key: p for key, p in paths.items() if not p.exists()}
    seconds, log = 0.0, ""
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        start = time.perf_counter()
        with ThreadPoolExecutor(len(todo)) as pool:
            log = "".join(pool.map(_compile, todo, todo.values()))
        seconds = time.perf_counter() - start
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


# ------------------------------------------------------------------ wrappers


def _check(q, k, v, mask, dout=None, lse=None, delta=None):
    """Shapes, types, device and contiguity the kernels take: q, k, v and dO
    (B, N, H, Dh) alike, the mask (B, N, N), L and Δ (B, H, N) f32."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, N, H, Dh), got {tuple(q.shape)}")
    b, n, h, dh = q.shape
    like_q = {"k": k, "v": v, "dout": dout}
    rows = {"lse": lse, "delta": delta}
    for name, t in like_q.items():
        if t is not None and (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not match q")
    for name, t in rows.items():
        if t is not None and (t.shape != (b, h, n) or t.dtype != torch.float32 or t.device != q.device):
            raise ValueError(f"{name} must be (B, H, N) float32 on {q.device}, got {tuple(t.shape)} {t.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"kernel is built for head widths {HEAD_DIMS}, got {dh}")
    if mask.shape != (b, n, n) or mask.dtype not in (torch.bool, torch.int8) or mask.device != q.device:
        raise ValueError(f"mask must be (B, N, N) bool/int8 on {q.device}, got {tuple(mask.shape)} {mask.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, mask, dout, lse, delta) if t is not None):
        raise ValueError("the kernels' inputs must be contiguous")


def _launch(name: str, *tensors: torch.Tensor) -> None:
    """Call kernel ``name`` on ``tensors`` (inputs then outputs, all on one
    card) with q's shape, on the current stream; raise on a CUDA error."""
    q = tensors[0]
    b, n, h, dh = q.shape
    rc = load_library().fn(name)(
        *(t.data_ptr() for t in tensors), b, n, h, dh, _DTYPES[q.dtype], 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def masked_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused masked attention forward: O (B, N, H, Dh) and L (B, H, N) f32.

    CUDA tensors launch the kernel on the current stream; CPU tensors use
    ``masked_attention_fwd_plain``.
    """
    if not q.is_cuda:
        return masked_attention_fwd_plain(q, k, v, mask)
    _check(q, k, v, mask)
    b, n, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch("masked_attention_fwd", q, k, v, mask, o, lse)
    masked_attention_fwd.launches += 1
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
    _launch("masked_attention_bwd_dq", q, k, v, mask, dout, lse, delta, dq)
    masked_attention_bwd_dq.launches += 1
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
    _launch("masked_attention_bwd_dkv", q, k, v, mask, dout, lse, delta, dk, dv)
    masked_attention_bwd_dkv.launches += 1
    return dk, dv


masked_attention_fwd.launches = 0
masked_attention_bwd_dq.launches = 0
masked_attention_bwd_dkv.launches = 0
KERNELS = (masked_attention_fwd, masked_attention_bwd_dq, masked_attention_bwd_dkv)


class MaskedAttention(torch.autograd.Function):
    """Masked attention (B, N, H, Dh) × (B, N, N) → (B, N, H, Dh) whose
    forward and backward are the kernels above (the JAX package's
    ``custom_vjp`` of ``flash_masked_attention``). The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        o, lse = masked_attention_fwd(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, mask, o, lse = ctx.saved_tensors
        dout = grad_out.contiguous()
        delta = attention_delta(dout, o)
        dq = masked_attention_bwd_dq(q, k, v, mask, dout, lse, delta)
        dk, dv = masked_attention_bwd_dkv(q, k, v, mask, dout, lse, delta)
        return dq, dk, dv, None
