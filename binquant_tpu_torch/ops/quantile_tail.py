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
  torch twin: the same sort-once, select-per-window bookkeeping the kernel
  performs, so the CPU tests cover the kernel's algorithm.

``launches`` counts kernel launches (never twin calls), so a run can show
that its main path went through the kernel; ``launches_by_site`` splits the
same count by the caller's ``site`` label (``abp_core`` on every full tick,
``abp_init_from_window`` on every carry resync); ``twin_calls_by_site``
counts the calls the twin served, so a CPU drive's count can be held
against a card drive's launches; ``launches_by_shard`` counts the launches
made inside a sharded tick's shard programs (``parallel/collectives.py``)
by shard. Inside an open profiler window
(``obs/tracing.py``) each launch runs in a ``qtail_launch[<site>]`` range. The first use records
the build in the kernel-build ledger (``obs/ledger.py``, ``qt.build``).

On the card the kernel is latency-bound (see the note in ``qtail.cu``): at
ActivityBurstPump's shape it reads ~0.7 MB, sorts each row's 83 tail values
once and selects its 4 windows' order statistics from that one ordering.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from binquant_tpu_torch.obs.ledger import LEDGER
from binquant_tpu_torch.obs.tracing import profiler_window_active
from binquant_tpu_torch.parallel.collectives import current_shard

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "qtail.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

launches = 0  # kernel launches since import (or the caller's last reset)
launches_by_site: dict[str, int] = {}  # the same launches by call site
twin_calls_by_site: dict[str, int] = {}  # calls the twin served (CPU tensors), by site
launches_by_shard: dict[int, int] = {}  # a sharded tick's launches, by shard
_lib: ctypes.CDLL | None = None
_max_span: int | None = None  # the largest window + num_out - 1 the kernel takes


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_site.clear()
    twin_calls_by_site.clear()
    launches_by_shard.clear()


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
    for this source is already built. The process's first call records the
    build in the kernel-build ledger: ``cold`` with the nvcc seconds, or
    ``warm`` when the library was reused."""
    out = library_path()
    if out.exists():
        _record_build(out, 0.0)
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
    _record_build(out, seconds)
    return out, seconds


_build_recorded = False


def _record_build(path: Path, seconds: float) -> None:
    global _build_recorded
    if _build_recorded:
        return
    _build_recorded = True
    LEDGER.record(
        "qt.build",
        f"{SOURCE.relative_to(_PKG_DIR).as_posix()} sm_90a {path.stem}",
        seconds,
        "cold" if seconds > 0 else "warm",
    )


def _load() -> ctypes.CDLL:
    global _lib, _max_span
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.qtail_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.qtail_launch.restype = ctypes.c_int
        lib.qtail_max_span.argtypes = []
        lib.qtail_max_span.restype = ctypes.c_int
        _max_span = int(lib.qtail_max_span())
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

    The same selection ``csrc/qtail.cu`` performs: the row's last
    ``T = window + num_out - 1`` columns (NaN before the row start,
    non-finite values as +inf) are sorted once by value, then column; for
    output k the window is the columns ``k <= col < k + window``, and its
    lo-th and hi-th members in that one order are its order statistics.
    Bit-equal to the reference's per-window sort."""
    mp, K = _resolve(x, window, num_out, min_periods)
    L = window
    T = L + K - 1
    W = x.shape[-1]
    tail = x[..., -min(T, W):].to(torch.float32)
    if W < T:  # positions before the array start are NaN
        pad = torch.full(
            tail.shape[:-1] + (T - W,), float("nan"),
            dtype=torch.float32, device=x.device,
        )
        tail = torch.cat([pad, tail], dim=-1)
    val = torch.where(torch.isfinite(tail), tail, float("inf"))
    # stable: equal values keep column order
    sval, col = torch.sort(val, dim=-1, stable=True)  # (..., T)

    k = torch.arange(K, device=x.device)[:, None]
    col = col[..., None, :]  # (..., 1, T)
    member = (col >= k) & (col < k + L)  # (..., K, T): window k, sorted order
    cnt = (member & torch.isfinite(sval)[..., None, :]).sum(dim=-1, dtype=torch.int32)
    rankf = q * (cnt.to(torch.float32) - 1.0)
    lo = torch.clamp(torch.floor(rankf).to(torch.int32), 0, L - 1)
    hi = torch.minimum(torch.clamp(lo + 1, max=L - 1), torch.clamp(cnt - 1, min=0))

    # members before and at each sorted position; the r-th member is the
    # first position where that count reaches r + 1
    seen = member.cumsum(dim=-1, dtype=torch.int32)

    def select(r: torch.Tensor) -> torch.Tensor:
        pos = (seen == r[..., None] + 1).to(torch.int32).argmax(dim=-1)
        return torch.gather(sval, -1, pos.long())

    v_lo, v_hi = select(lo), select(hi)
    out = v_lo + (v_hi - v_lo) * (rankf - lo.to(torch.float32))
    return torch.where(cnt >= mp, out, float("nan"))


def rolling_quantile_tail(
    x: torch.Tensor,
    window: int,
    q: float,
    num_out: int = 1,
    min_periods: int | None = None,
    site: str = "direct",
) -> torch.Tensor:
    """Trailing rolling quantile of a 2-D float32 ``(S, W)`` tensor at its
    last ``num_out`` positions, ``(S, num_out)``. CUDA tensors launch the
    kernel; CPU tensors run the twin; anything else raises. ``site`` names
    the caller in ``launches_by_site``."""
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
        twin_calls_by_site[site] = twin_calls_by_site.get(site, 0) + 1
        return rolling_quantile_tail_reference(x, window, q, num_out, min_periods)
    if x.device.type != "cuda":
        raise ValueError(f"rolling_quantile_tail: unsupported device {x.device}")

    if x.device.index != torch.cuda.current_device():
        raise ValueError(
            f"rolling_quantile_tail: {x.device} is not the current device "
            f"cuda:{torch.cuda.current_device()}"
        )
    lib = _load()
    mp, K = _resolve(x, window, num_out, min_periods)
    if window + K - 1 > _max_span:
        raise ValueError(
            f"window + num_out - 1 = {window + K - 1} passes the kernel's limit {_max_span}"
        )
    S, W = x.shape
    out = torch.empty((S, K), dtype=torch.float32, device=x.device)
    # a named range in an open profiler window (the trace names the launch
    # on the host side; the kernel itself shows on the device side)
    rng = (
        torch.profiler.record_function(f"qtail_launch[{site}]")
        if profiler_window_active()
        else contextlib.nullcontext()
    )
    with rng:
        err = lib.qtail_launch(
            x.data_ptr(), out.data_ptr(), S, W, window, K, float(q), mp,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"qtail kernel launch failed: cudaError {err}")
    launches += 1
    launches_by_site[site] = launches_by_site.get(site, 0) + 1
    shard = current_shard()
    if shard is not None:
        launches_by_shard[shard] = launches_by_shard.get(shard, 0) + 1
    return out
