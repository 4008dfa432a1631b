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

No kernel here writes a result that autograd can follow. So a CUDA
operand that requires a gradient, with grad mode on, is refused
(``refuse_grad``, from ``operands``, which every wrapper's CUDA branch
calls) unless the wrapper is a ``torch.autograd.Function`` whose backward
is a kernel too (``flash_attention``, ``gla_forward``): the card never
hands back a result without a ``grad_fn`` where the CPU's plain version
would have one.
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
           "flash_attention", "gla_forward", "flash_attention_bwd", "gla_backward")
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
    "repro_fleet_ingest_project": [_P] * 4 + [_I] * 5 + [_P],
    "repro_fleet_ingest_update": [_P] * 9 + [_I] * 4 + [_F, _P],
    "repro_masked_segment_sum": [_P, _P, _P, _P, _I, _L, _I, _P],
    "repro_segment_sum": [_P, _P, _P, _I, _L, _I, _P],
    "repro_segment_broadcast": [_P, _P, _P, _I, _L, _P],
    "repro_banded_mix": [_P, _P, _I, _L, _I, _P],
    "repro_uv_solve": [_P, _L, _L, _P, _L, _L, _P, _P, _I, _I, _I, _F, _P, _P],
    "repro_banded_merge_solve": [_P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    "repro_quantize_pack": [_P] * 6 + [_I] * 3 + [_P],
    "repro_robust_segment_sum": [_P] * 7 + [_I, _L, _I, _P, _I, _P],
    "repro_dense_mix": [_P, _P, _P, _P, _I, _L, _P],
    "repro_hidden_proj": [_P] * 5 + [_I] * 7 + [_P],
    "repro_matmul_atb": [_P] * 4 + [_I] * 7 + [_P],
    "repro_rank1_add": [_P] * 4 + [_F, _P, _I, _I, _I, _P],
    "repro_k1_update": [_P] * 7 + [_I, _I, _P],
    "repro_flash_attention": [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P],
    "repro_flash_attention_bwd": [_P] * 11 + [_I] * 6 + [_F, _I, _P],
    "repro_gla_forward": [_P] * 8 + [_I] * 7 + [_P],
    "repro_gla_backward": [_P] * 15 + [_I] * 10 + [_P],
    "repro_gla_bwd_pad": [_P] * 4 + [_L, _I, _P],
    "repro_gla_smem": [_I] * 2,
    "repro_ingest_beta_tile": [],
    "repro_ingest_chunk": [_I],
}
# entries that return a count of workspace floats
_SIZES = {
    "repro_uv_solve_ws": [_I, _I, _I],
    "repro_robust_ws": [_I, _I, _L],
    "repro_gla_bwd_parts": [_I] * 7,
}


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry's ``argtypes`` set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in {**_SIGNATURES, **_SIZES}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong if name in _SIZES else ctypes.c_int
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


def workspace(floats: int, device: torch.device) -> torch.Tensor | None:
    """A kernel's f32 scratch of ``floats`` elements (a C entry's
    ``*_ws`` count), or None where it needs none."""
    return torch.empty(floats, dtype=torch.float32, device=device) if floats else None


def ptr(t: torch.Tensor | None) -> int | None:
    """The device pointer a C entry takes, null for no tensor."""
    return None if t is None else t.data_ptr()


F32 = (torch.float32,)
F32_BF16 = (torch.float32, torch.bfloat16)


def on_cpu(t: torch.Tensor) -> bool:
    """Whether a wrapper runs its plain version for ``t``: a CPU tensor. The
    attention and GLA wrappers dispatch through it, so a CPU test can send
    a CPU tensor down their CUDA branch up to the checks before a launch."""
    return t.device.type == "cpu"


# what listens to the plain versions' runs: the dry run's op counter
# (repro_torch.roofline.op_costs.OpCounter) while it counts, else None
plain_listener = None


def plain(kernel: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, ``kernel``'s plain version, on the route a
    wrapper takes where ``on_cpu`` says so. A listener set in
    ``plain_listener`` is told where the run begins and ends, so that the
    ops inside it can be told apart as the kernel's interior."""
    listener = plain_listener
    if listener is None:
        return fn(*args, **kwargs)
    listener.enter_plain(kernel)
    try:
        out = fn(*args, **kwargs)
    finally:
        listener.exit_plain(kernel)
    listener.kernel_operands(kernel, (args, kwargs), out)
    return out


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` where grad mode is on and one of
    ``tensors`` requires a gradient: ``kernel`` has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: an operand requires a gradient, and the kernel has no backward on the "
            f"card (no training path needs one); call it under torch.no_grad() or on the CPU")


def operands(kernel: str, dtypes: tuple[torch.dtype, ...] = F32, *, unit_last: bool = False,
             **tensors: torch.Tensor) -> list[torch.Tensor]:
    """The ``tensors`` as ``kernel`` reads them, in the order given.

    - Every tensor must lie on the first one's device (``ValueError``).
    - Every tensor must be of a floating type (``TypeError`` on an integer,
      bool or complex tensor). Operands all of one type in ``dtypes`` keep
      it; any other mix (bf16 with f32, f16, f64) is cast to f32, the type
      the reference computes it in (jax promotes bf16 with f32 to f32 and,
      with 64-bit floats off, takes f64 as f32), as the plain versions do.
    - A strided operand is copied contiguous; with ``unit_last`` only one
      whose last axis is strided (the kernel takes the other strides).

    A tensor that needs neither cast nor copy is returned as it is. An
    operand that requires a gradient, with grad mode on, is refused
    (``refuse_grad``).
    """
    refuse_grad(kernel, *tensors.values())
    first = next(iter(tensors.values()))
    device, dtype = first.device, first.dtype
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, {next(iter(tensors))} on "
                             f"{device}")
        if t.dtype != dtype:
            dtype = None
    if dtype not in dtypes:  # a mix, or one type the kernel does not take
        for name, t in tensors.items():
            if not t.is_floating_point():
                raise TypeError(f"{kernel}: {name} must be a floating-point tensor, got {t.dtype}")
        dtype = torch.float32
    out = []
    for t in tensors.values():
        if t.dtype != dtype:
            t = t.to(dtype)
        if not (t.stride(-1) == 1 if unit_last and t.ndim else t.is_contiguous()):
            t = t.contiguous()
        out.append(t)
    return out
