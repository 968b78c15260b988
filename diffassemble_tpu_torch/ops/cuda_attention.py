"""Host side of the hand-written CUDA masked-attention forward kernel.

``csrc/masked_attention_fwd.cu`` replaces the TPU kernel ``_attn_kernel`` of
the JAX package's ``ops/pallas_attention.py`` (launched by ``_flash_fwd``). It
is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use, cached under ``diffassemble_tpu_torch/_build/`` by the
source's hash, and loaded with ``ctypes``.

``masked_attention_fwd`` launches the kernel for CUDA tensors and counts each
launch in ``masked_attention_fwd.launches``; for CPU tensors it computes the
kernel's plain PyTorch version, ``masked_attention_fwd_plain``. There is no
fall back from the card to the plain version.
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
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "masked_attention_fwd.cu"
BUILD_DIR = _PKG / "_build"
# the TPU kernel this one replaces, in the JAX package (REFERENCE_PACKAGE)
REPLACES = "ops/pallas_attention.py:62"
HEAD_DIMS = (32, 144)  # head widths the kernel is instantiated for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e9
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class KernelLibrary:
    """The loaded shared library and how it was built."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    compiler_log: str  # nvcc's output, including the -Xptxas -v lines


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the attention kernel")


@functools.cache
def load_library() -> KernelLibrary:
    """Build the kernel library (once per source hash, kept in ``BUILD_DIR``)
    and load it, once per process: launches pay no hashing or file access."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"masked_attention_fwd-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        start = time.perf_counter()
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300, check=True)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed:\n{e.stdout}\n{e.stderr}") from e
        seconds = time.perf_counter() - start
        log = res.stdout + res.stderr
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    fn = lib.masked_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return KernelLibrary(lib, out, seconds, log)


def masked_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (the Pallas ``_attn_kernel``'s math).

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


def _check(q, k, v, mask):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, N, H, Dh), got {tuple(q.shape)}")
    b, n, h, dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not match q")
    if q.dtype not in _DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"kernel is built for head widths {HEAD_DIMS}, got {dh}")
    if mask.shape != (b, n, n) or mask.dtype not in (torch.bool, torch.int8) or mask.device != q.device:
        raise ValueError(f"mask must be (B, N, N) bool/int8 on {q.device}, got {tuple(mask.shape)} {mask.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, mask)):
        raise ValueError("q, k, v and mask must be contiguous")


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
    b, n, h, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lib = load_library().lib
    rc = lib.masked_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, n, h, dh, _DTYPES[q.dtype], 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"masked_attention_fwd launch failed: CUDA error {rc}")
    masked_attention_fwd.launches += 1
    return o, lse


masked_attention_fwd.launches = 0
