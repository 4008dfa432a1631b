"""Hidden-layer projection H = G(x·α + b); port of
``repro.kernels.hidden_proj``.

``hidden_proj`` takes ``hidden_proj_plain`` for CPU tensors and launches
the kernel of ``csrc/hidden_proj.cu`` for CUDA tensors, or raises. The
operands are f32 or bf16 (all three of one type) and the result is f32,
summed in f32 with the bias and activation applied to the finished sum,
as the reference's kernel does. Past four rows the kernel cuts the
feature axis K into the slices of ``matmul_atb.split_plan`` (one block per
output tile and slice, then the slices added in order); up to four rows,
the k=1 step's shape, one cluster of blocks per 32 columns does (see
``csrc/hidden_proj.cu``). Either way each output is summed in a fixed
order of its own, so two calls give the same bits; the plain version is a
PyTorch matrix product, so the two agree to f32 rounding, not bit for bit.

A registered activation that has no code of the kernel's (a new name, or
a built-in name registered again) is taken in one launch all the same:
the kernel projects with the identity code and the wrapper applies the
registered function once to the kernel's output, as the plain version
applies it to its sum.
"""
from __future__ import annotations

import torch

from repro_torch.core.activations import ACTIVATION_CODES, get_activation, kernel_code
from repro_torch.kernels import _lib
from repro_torch.kernels.matmul_atb import split_plan

__all__ = ["hidden_proj", "hidden_proj_plain"]


def _check(x: torch.Tensor, alpha: torch.Tensor, bias: torch.Tensor) -> None:
    if alpha.ndim != 2 or x.ndim < 1 or x.shape[-1] != alpha.shape[0]:
        raise ValueError(f"hidden_proj: x {tuple(x.shape)} and alpha {tuple(alpha.shape)} "
                         "do not chain as (..., K) · (K, N)")
    if bias.shape != (alpha.shape[1],):
        raise ValueError(f"hidden_proj: bias must be ({alpha.shape[1]},); got {tuple(bias.shape)}")


def hidden_proj_plain(
    x: torch.Tensor, alpha: torch.Tensor, bias: torch.Tensor, *, activation: str = "sigmoid"
) -> torch.Tensor:
    _check(x, alpha, bias)
    return get_activation(activation)(x.float() @ alpha.float() + bias.float())


def hidden_proj(
    x: torch.Tensor, alpha: torch.Tensor, bias: torch.Tensor, *, activation: str = "sigmoid"
) -> torch.Tensor:
    """H = G(x·α + b) for x (..., K), α (K, N), b (N,) → (..., N) f32."""
    if x.device.type == "cpu":
        return hidden_proj_plain(x, alpha, bias, activation=activation)
    _check(x, alpha, bias)
    code = kernel_code(activation)  # raises on an unknown name
    bf16 = _lib.require_cuda_f32_or_bf16("hidden_proj", x=x, alpha=alpha, bias=bias)
    k, n = alpha.shape
    m = x.numel() // k
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    # x (m, k) is the left operand with k contracted: AᵀB's plan with n1 = m
    length, slices, ws_numel = split_plan(1, k, m, n)
    ws = torch.empty(ws_numel, dtype=torch.float32, device=x.device) if ws_numel else None
    status = _lib.library().repro_hidden_proj(
        x.data_ptr(), alpha.data_ptr(), bias.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), m, k, n, max(length, 1), slices,
        ACTIVATION_CODES["identity"] if code is None else code, bf16, _lib.stream(),
    )
    _lib.check(status, "hidden_proj")
    _lib.count_launch("hidden_proj")
    return get_activation(activation)(out) if code is None else out
