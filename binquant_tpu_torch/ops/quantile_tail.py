"""The trailing rolling quantile: the card's CUDA kernel and its plain twin.

:func:`rolling_quantile_tail` is the one entry point. It replaces the TPU
kernel ``_qtail_kernel`` / ``rolling_quantile_tail_pallas``
(``binquant_tpu/ops/pallas_rolling.py``) and the XLA windowed sort behind
``binquant_tpu.ops.rolling.rolling_quantile_tail``: the last ``num_out``
positions of the pandas ``rolling(window).quantile(q, 'linear')`` series of
each row, NaN-aware, with ``min_periods``.

* On a CUDA tensor it launches ``csrc/qtail.cu`` (built at first use with
  ``nvcc`` for ``sm_90a`` into ``build/``, loaded with ``ctypes``) on the
  current stream, or raises. There is no fallback.
* On a CPU tensor it runs :func:`rolling_quantile_tail_reference`, the plain
  torch twin: the same count-rank selection the kernel performs, so the CPU
  tests cover the kernel's algorithm.

``launches`` counts kernel launches (never twin calls), so a run can show
that its main path went through the kernel.

On the card the kernel is latency-bound (see the note in ``qtail.cu``): at
ActivityBurstPump's shape it reads ~0.7 MB and does ~52 M compare-adds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "qtail.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

launches = 0  # kernel launches since import (or the caller's last reset)
_lib: ctypes.CDLL | None = None
_max_window: int | None = None


def reset_launches() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the qtail kernel is built on a CUDA host")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libqtail_{digest.hexdigest()[:12]}.so"


def build_command(out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(SOURCE)]


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile ``csrc/qtail.cu`` (once per source revision) and return
    ``(library path, seconds spent compiling)``; 0 seconds when the library
    for this source is already built."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = build_command(tmp)
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr.strip())
    tmp.replace(out)
    return out, seconds


def _load() -> ctypes.CDLL:
    global _lib, _max_window
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.qtail_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.qtail_launch.restype = ctypes.c_int
        lib.qtail_max_window.argtypes = []
        lib.qtail_max_window.restype = ctypes.c_int
        _max_window = int(lib.qtail_max_window())
        _lib = lib
    return _lib


def _resolve(x: torch.Tensor, window: int, num_out: int, min_periods):
    mp = max(min_periods if min_periods is not None else window, 1)
    K = min(num_out, x.shape[-1])
    return mp, K


def rolling_quantile_tail_reference(
    x: torch.Tensor,
    window: int,
    q: float,
    num_out: int = 1,
    min_periods: int | None = None,
) -> torch.Tensor:
    """Plain torch twin of the kernel, ``(..., W) -> (..., num_out)``.

    For each trailing window: non-finite values become +inf, each element's
    rank is the count of elements ordered before it (value, then index), and
    the lo/hi order statistics are the elements whose rank equals lo/hi —
    exactly the count-rank selection of ``csrc/qtail.cu`` and of the TPU
    kernel, and bit-equal to the reference's windowed sort."""
    mp, K = _resolve(x, window, num_out, min_periods)
    L = window
    need = L + K - 1
    W = x.shape[-1]
    tail = x[..., -min(need, W):].to(torch.float32)
    if W < need:  # positions before the array start are NaN
        pad = torch.full(
            tail.shape[:-1] + (need - W,), float("nan"),
            dtype=torch.float32, device=x.device,
        )
        tail = torch.cat([pad, tail], dim=-1)
    win = tail.unfold(-1, L, 1)  # (..., K, L)
    finite = torch.isfinite(win)
    wv = torch.where(finite, win, float("inf"))
    cnt = finite.sum(dim=-1, dtype=torch.int32)

    col = torch.arange(L, device=x.device)
    vi = wv[..., :, None]  # element i along -2
    vj = wv[..., None, :]  # element j along -1
    # j orders before i: a smaller value, or an equal one at a lower index
    before = torch.where(col[None, :] < col[:, None], vj <= vi, vj < vi)
    rank = before.sum(dim=-1, dtype=torch.int32)  # a permutation of 0..L-1

    rankf = q * (cnt.to(torch.float32) - 1.0)
    lo = torch.clamp(torch.floor(rankf).to(torch.int32), 0, L - 1)
    hi = torch.minimum(torch.clamp(lo + 1, max=L - 1), torch.clamp(cnt - 1, min=0))

    def select(r: torch.Tensor) -> torch.Tensor:
        pos = (rank == r[..., None]).to(torch.int32).argmax(dim=-1)
        return torch.gather(wv, -1, pos.long()[..., None])[..., 0]

    v_lo, v_hi = select(lo), select(hi)
    out = v_lo + (v_hi - v_lo) * (rankf - lo.to(torch.float32))
    return torch.where(cnt >= mp, out, float("nan"))


def rolling_quantile_tail(
    x: torch.Tensor,
    window: int,
    q: float,
    num_out: int = 1,
    min_periods: int | None = None,
) -> torch.Tensor:
    """Trailing rolling quantile of a 2-D float32 ``(S, W)`` tensor at its
    last ``num_out`` positions, ``(S, num_out)``. CUDA tensors launch the
    kernel; CPU tensors run the twin; anything else raises."""
    global launches
    if not isinstance(x, torch.Tensor):
        raise TypeError("rolling_quantile_tail expects a torch.Tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"rolling_quantile_tail expects float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"rolling_quantile_tail expects (S, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("rolling_quantile_tail expects a contiguous tensor")
    if window < 1 or num_out < 1:
        raise ValueError("window and num_out must be >= 1")
    if x.device.type == "cpu":
        return rolling_quantile_tail_reference(x, window, q, num_out, min_periods)
    if x.device.type != "cuda":
        raise ValueError(f"rolling_quantile_tail: unsupported device {x.device}")

    lib = _load()
    if window > _max_window:
        raise ValueError(f"window {window} exceeds the kernel's {_max_window}")
    mp, K = _resolve(x, window, num_out, min_periods)
    S, W = x.shape
    out = torch.empty((S, K), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.qtail_launch(
            x.data_ptr(), out.data_ptr(), S, W, window, K, float(q), mp, stream
        )
    if err != 0:
        raise RuntimeError(f"qtail kernel launch failed: cudaError {err}")
    launches += 1
    return out
