"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by plain ``nvcc`` for ``sm_90a`` into its
own shared library with a C interface and loaded with ``ctypes``.  The build
happens at first use (or in :func:`build_all`, which starts one ``nvcc`` per
source at once), from the sources in this checkout, into ``build/kernels/``
at the repository root.  Libraries are named by a hash of their sources, so
an edited kernel is rebuilt.

Each wrapper adds one to :data:`launches` under its kernel's name where it
launches the kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("hashgrid", "encode_grad", "broyden", "march", "resample",
           "compact", "deform", "seedgrid", "volrend")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              # no multiply-add contraction: the kernels then round like
              # their plain PyTorch twins, which the checks compare against
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float
# C signatures: every function returns an int, the launching ones
# cudaGetLastError() after their launch
SIGNATURES = {
    "hashgrid": {
        "hashgrid_encode_fwd": (
            P, P, P, P, P, P, I64, I32, I32, I32, I32, F32, F32, P),
        "hashgrid_encode_fwd_bf16": (
            P, P, P, P, P, P, I64, I32, I32, I32, I32, F32, F32, P),
        "hashgrid_encode_bwd": (
            P, P, P, P, P, P, P, P, I64, I32, I32, I32, I32, F32, P)},
    "encode_grad": {
        "encode_mlp_sdfgrad_fwd": (
            P, P, P, P, P, P, P, P, P, P, P, I64, I32, I32, I32, I32,
            I32, I32, I32, F32, F32, P),
        "encode_mlp_sdfgrad_fwd_bf16": (
            P, P, P, P, P, P, P, P, P, P, P, I64, I32, I32, I32, I32,
            I32, I32, I32, F32, F32, P),
        "encode_mlp_sdfgrad_bwd_gather": (
            P, P, P, P, P, P, P, P, I64, I32, I32, I32, I32, F32, F32, P),
        "encode_mlp_sdfgrad_bwd_scatter": (
            P, P, P, P, P, P, P, P, P, P, I64, I32, I32, I32, I32, F32,
            P)},
    "broyden": {
        "broyden_search_fwd": (
            P, P, P, P, P, P, P, I64, I32, I32, I32, I32,
            F32, F32, F32, F32, F32, F32, F32, F32, P),
        "broyden_polish_fwd": (
            P, P, P, P, P, P, P, I64, I32, I32, I32, I32,
            F32, F32, F32, F32, F32, F32, F32, F32, P)},
    "march": {
        "occupancy_march_fwd": (
            P, P, P, P, P, P, P, I64, I32, I32, F32, P, P, P, P, P),
        "secondary_march_fwd": (
            P, P, P, P, P, P, P, I64, I32, I32, F32, I32, P, P, P, P)},
    "resample": {
        "merge_resample_fwd": (
            P, P, P, P, P, I64, I32, I32, F32, F32, P, P, P, P, P, P, P),
        "cdf_resample_fwd": (
            P, P, P, P, P, I64, I32, I32, F32, F32, P, P, P, P, P, P, P, P),
        "fine_resample_smem": (I32, I32),
        "fine_resample_fwd": (
            P, P, P, P, P, I64, I32, I32, F32, F32, I32, P, P, P, P)},
    "compact": {
        "compact_counts_len": (I64, I64, I64, I32),
        "compact_indices_fwd": (P, I64, I64, I64, I32, I64, P, P, P, P)},
    "deform": {
        "deform_prologue_fwd": (P, P, P, I64, I32, I32, P, P),
        "deform_epilogue_fwd": (P, P, P, I64, I32, I32, F32, P, P, P, P, P),
        "deform_skinning_fwd": (P, P, I64, I32, I32, I32, F32, F32, F32,
                                F32, F32, P, P),
        "deform_skinning_bwd": (P, P, P, P, P, P, I64, I32, I32, I32, F32,
                                F32, F32, F32, F32, P, I32, P, P)},
    "seedgrid": {
        "seed_gather_fwd": (P, P, P, P, I64, I32, I32, F32, F32, P, P, P, P)},
    "volrend": {
        "volrend_weights_fwd": (P, P, P, P, I64, I32, P)},
}

launches: collections.Counter = collections.Counter()
_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES, verbose: bool = False) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns ``{name: compiler output}``; raises on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def lib(name: str):
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not path.exists():
                build_all((name,))
            handle = ctypes.CDLL(str(path))
            for fn, args in SIGNATURES[name].items():
                f = getattr(handle, fn)
                f.argtypes = list(args)
                f.restype = ctypes.c_int
            _libs[name] = handle
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with error {err}")


def stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream.  The private
    binding takes ~0.2 us of host time where ``torch.cuda.current_stream(
    device).cuda_stream``, which builds a Stream object, takes ~6 us: more
    than a small kernel's time on the card."""
    import torch
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def require(t, name, dtype, device, shape=None):
    """Device, dtype, shape and contiguity checks before a raw pointer is
    handed to a kernel."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None:
        for i, s in enumerate(shape):
            if s is not None and (t.dim() <= i or t.shape[i] != s):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected {shape}")
        if t.dim() != len(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
