"""Build, load and count the port's CUDA kernels.

The sources under ``repro_torch/csrc`` have a plain C interface. At
first use they are compiled with ``nvcc`` for ``sm_90a`` (one process per
source, all started together), linked into one shared library and loaded
with ``ctypes``. The library lands in ``build/kernels/<hash>/`` at the
root of the checkout, keyed by a hash of the sources, so an edited
source is rebuilt and an unchanged one is not. Nothing is built when a
module is imported, so the CPU tests import every module without a
compiler.

Every wrapper adds one to its entry of the launch counts each time it
launches its kernel on a CUDA tensor; ``reset_launch_counts`` and
``launch_counts`` let a run show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

KERNELS = ("fleet_ingest", "masked_segment_sum_mix", "from_uv_solve", "banded_merge_solve",
           "quantize_pack", "robust_segment_sum_mix", "dense_mix",
           "hidden_proj", "matmul_atb", "rank1_add",
           "segment_sum_mix", "segment_broadcast", "banded_mix",
           "flash_attention", "gla_forward")
_launches = dict.fromkeys(KERNELS, 0)


def count_launch(name: str) -> None:
    _launches[name] += 1


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels cannot be built"
    )


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into ``build/kernels/<hash>/librepro_torch.so``
    unless that file exists; raise with the compiler's output on failure."""
    out_dir = BUILD_ROOT / _sources_digest()
    lib = out_dir / "librepro_torch.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        for cmd, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"$ {' '.join(cmd)}\n{out}")
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
        staged = Path(tmp) / lib.name
        cmd = [nvcc, "-shared", "-o", str(staged), *(str(o) for _, o, _ in procs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"CUDA kernel link failed:\n$ {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(staged, lib)  # atomic: a concurrent build sees all or nothing
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

_SIGNATURES = {
    "repro_fleet_ingest": [_P] * 12 + [_I] * 6 + [_F, _P],
    "repro_masked_segment_sum": [_P, _P, _P, _P, _I, _L, _P],
    "repro_segment_sum": [_P, _P, _P, _I, _L, _P],
    "repro_segment_broadcast": [_P, _P, _P, _I, _L, _P],
    "repro_banded_mix": [_P, _P, _I, _L, _I, _P],
    "repro_uv_solve": [_P, _L, _L, _P, _L, _L, _P, _P, _I, _I, _I, _F, _P],
    "repro_banded_merge_solve": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "repro_quantize_pack": [_P] * 6 + [_I] * 3 + [_P],
    "repro_robust_segment_sum": [_P] * 7 + [_I, _L, _I, _P],
    "repro_dense_mix": [_P, _P, _P, _I, _L, _P],
    "repro_hidden_proj": [_P] * 4 + [_I] * 5 + [_P],
    "repro_matmul_atb": [_P] * 4 + [_I] * 7 + [_P],
    "repro_rank1_add": [_P] * 4 + [_F, _P, _I, _I, _I, _P],
    "repro_flash_attention": [_P] * 4 + [_I] * 6 + [_F, _I, _P],
    "repro_gla_forward": [_P] * 6 + [_I] * 7 + [_P],
    "repro_gla_smem": [_I] * 3,
    "repro_quantize_pack_smem": [_I],
    "repro_ingest_gain_smem": [_I],
    "repro_ingest_beta_smem": [_I],
    "repro_ingest_beta_tile": [],
    "repro_solve_smem": [_I],
    "repro_solve_tile": [],
}


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry's ``argtypes`` set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [_I]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(status: int, kernel: str) -> None:
    """Raise when a C entry returned a CUDA error."""
    if status != 0:
        what = library().repro_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA error {status} ({what}) at launch")


# 227 KB: the shared memory one block may use on Hopper
MAX_SMEM = 232_448


def require_cuda(kernel: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Every tensor a kernel touches must be a contiguous CUDA tensor of
    ``dtype``."""
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not on a CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def require_cuda_f32(kernel: str, **tensors: torch.Tensor) -> None:
    require_cuda(kernel, torch.float32, **tensors)


def require_cuda_f32_or_bf16(kernel: str, **tensors: torch.Tensor) -> int:
    """Like ``require_cuda``, for kernels that read f32 or bf16 operands
    (all of one type); returns 1 for bf16, 0 for f32, the flag their C
    entries take."""
    dtype = next(iter(tensors.values())).dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: operands must be float32 or bfloat16, got {dtype}")
    require_cuda(kernel, dtype, **tensors)
    return int(dtype == torch.bfloat16)
