"""Build and bind the CUDA kernels: ``nvcc`` into one shared library with
a plain C interface, loaded with ``ctypes``.

The sources are ``csrc/*.cu``.  Each is compiled to an object by its own
``nvcc`` process, all started together, and the objects are linked into
``build/kernels/libfigmn_kernels-<hash>.so`` at the repository root (the
hash covers the sources and flags, so an edited source never loads a stale
library).  The build happens at first use, never at import: the CPU tests
import every module on a machine without ``nvcc``.

Every wrapper counts its launches in ``LAUNCHES`` (one per kernel launch,
nowhere else), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# -fmad=false: no multiply-add contraction, so each kernel rounds where its
# plain PyTorch version rounds (the kernels are bound by memory or by one
# block, not by the multiply-add rate).
NVCC_FLAGS = ("-std=c++17", "-O3", ARCH, "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES = {"matvec2": 0, "rank2_apply": 0, "figmn_stream": 0,
            "figmn_stream_grid": 0, "gathered_matvec": 0, "scatter_apply": 0,
            "mahalanobis": 0, "flash_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "figmn_error_string": ([_I], ctypes.c_char_p),
    "figmn_device_smem_optin": ([_I], _I),
    "figmn_device_sm_count": ([_I], _I),
    "figmn_device_coop_launch": ([_I], _I),
    "figmn_matvec2": ([_P, _P, _P, _P, _P, _I, _I, _P], _I),
    "figmn_rank2_apply": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _P], _I),
    "figmn_stream_smem_bytes": ([_I, _I], _L),
    "figmn_stream": ([_P, _I, _P, _P, _P, _P, _P, _F, _F, _F, _P, _P, _P,
                      _P, _P, _I, _I, _P], _I),
    "figmn_stream_grid_smem_bytes": ([_I, _I, _I], _L),
    "figmn_stream_grid_blocks_per_sm": ([_I, _L], _I),
    "figmn_stream_grid": ([_P, _I, _P, _P, _P, _P, _P, _F, _F, _F, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P], _I),
    "figmn_gathered_matvec": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "figmn_scatter_apply": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    "figmn_mahalanobis": ([_P, _P, _P, _I, _I, _P], _I),
    "figmn_flash_fwd_smem_bytes": ([_I], _L),
    "figmn_flash_fwd": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _F, _I, _P], _I),
    "figmn_flash_bwd_dq_smem_bytes": ([_I], _L),
    "figmn_flash_bwd_dkv_smem_bytes": ([_I], _L),
    "figmn_flash_bwd_dq": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _F, _I, _P], _I),
    "figmn_flash_bwd_dkv": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _I, _F, _I, _P], _I),
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log: str = ""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfigmn_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel and link the library (no-op when
    the library for these sources exists).  Raises with the compiler's
    output on failure."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}-{out.stem}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    for src, _, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch (or an attribute call before it) failed."""
    if err != 0:
        msg = lib().figmn_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {what} failed: {msg} ({err})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(name: str, t: Optional[torch.Tensor],
                 shape: Tuple[int, ...], device: torch.device,
                 dtypes: Tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    """What every kernel takes: float32 (or one of ``dtypes``), this
    shape, this device, contiguous.  None passes (an optional operand left
    out)."""
    if t is None:
        return
    if t.dtype not in dtypes:
        want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_index(name: str, t: torch.Tensor, shape: Tuple[int, ...],
                device: torch.device) -> None:
    """What every kernel takes as an index or mask vector: int32, this
    shape, this device, contiguous."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# A kernel that keeps one D-vector in shared memory stays within the 48 KB
# a block gets without opting in.
SMEM_VECTOR_MAX_D = 48 * 1024 // 4


def check_smem_vector(d: int) -> None:
    if d > SMEM_VECTOR_MAX_D:
        raise ValueError(f"D = {d} exceeds the {SMEM_VECTOR_MAX_D} floats a "
                         "block holds in shared memory without opting in")


def on_cuda(device: torch.device) -> bool:
    """True for a CUDA device (launch the kernel), False for the CPU (take
    the plain version); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def device_index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def smem_optin(device: torch.device) -> int:
    """Per-block opt-in shared memory of ``device`` in bytes, queried from
    the device (227 KB on H100)."""
    v = lib().figmn_device_smem_optin(device_index(device))
    if v <= 0:
        raise RuntimeError(f"could not query shared memory of {device}")
    return v


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (132 on H100 SXM)."""
    v = lib().figmn_device_sm_count(device_index(device))
    if v <= 0:
        raise RuntimeError(f"could not query the SM count of {device}")
    return v


def coop_launch(device: torch.device) -> bool:
    """Whether ``device`` supports cooperative launches (a grid whose
    blocks are guaranteed co-resident)."""
    v = lib().figmn_device_coop_launch(device_index(device))
    if v < 0:
        raise RuntimeError(f"could not query cooperative launch on {device}")
    return v == 1
