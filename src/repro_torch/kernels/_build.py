"""Build, load and launch bookkeeping for the hand-written CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled at first use by its own
``nvcc`` process (all started together) into a shared library with a plain C
interface, under ``build/repro_torch_kernels/`` at the repository root, and
loaded with ``ctypes``.  A library's file name carries a digest of its
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing here runs at import: the CPU tests import every
module of the package on a machine without ``nvcc``.

``LAUNCHES`` counts kernel launches by name.  Each wrapper adds one right
after it launches its kernel, and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = (
    "cascade", "cascade_chunk", "cascade_lane", "tree_scores", "lattice_scores",
    "mega_stage",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no multiply may contract into an add (threshold_step's partial sums,
    # the lattice halvings): scores and g stay bit-identical to the plain
    # PyTorch versions
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "repro_torch are compiled at first use on a machine with the CUDA "
        "toolkit; CPU tensors take the plain PyTorch versions instead"
    )


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every source not built yet, one ``nvcc`` each, all at once.

    Returns the seconds each compile took (0.0 for a library already on
    disk) and writes each compiler's output (``-Xptxas=-v``: registers,
    shared memory, spills) to ``<library>.log`` beside it.  Raises with the
    compiler's output when a compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = dict.fromkeys(SOURCES, 0.0)
    procs = {}
    for name in SOURCES:
        so = _library_path(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            time.perf_counter(), tmp, so,
        )
    failed = []
    for name, (proc, t0, tmp, so) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def function(source: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, built at first
    use.  Pointers and the stream must be ``c_void_p`` in ``argtypes``."""
    lib = _LIBS.get(source)
    if lib is None:
        so = _library_path(source)
        if not so.exists():
            build_all()
        lib = ctypes.CDLL(str(so))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(source: str, code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = _LIBS[source].kernel_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code}: {msg}")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(name: str, *tensors: tuple[str, torch.Tensor, torch.dtype]) -> None:
    """Every (label, tensor, dtype) lies on one CUDA device, has the dtype
    and is contiguous; raises naming the first that is not."""
    dev = tensors[0][1].device
    for label, t, dtype in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {label} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def n_valid_args(n_valid, limit: int, device: torch.device):
    """(device pointer | None, host value) for a kernel's live-row limit:
    ``None`` means every row, an int is passed by value, and an int32
    scalar tensor on ``device`` is read by the kernel (no host sync)."""
    if n_valid is None:
        return None, limit
    if isinstance(n_valid, torch.Tensor):
        if n_valid.device != device or n_valid.dtype != torch.int32 or n_valid.numel() != 1:
            raise ValueError(
                f"n_valid must be a one-element int32 tensor on {device}, got "
                f"{n_valid.dtype} {tuple(n_valid.shape)} on {n_valid.device}"
            )
        return n_valid.data_ptr(), 0
    return None, int(n_valid)
