"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro`` module by module and runs the fleet tick
(fused OS-ELM ingest, drift detection, merge governance and the masked
Eq. 8 merge) on one GPU through hand-written CUDA kernels
(``repro_torch.kernels``). It imports torch and numpy only.

Entry points take an explicit ``device``; they run on ``cuda`` unless
the caller passes ``device="cpu"``, and they raise when no card is
present and no CPU run was asked for. A kernel wrapper dispatches by the
device of the tensors it is given: CPU tensors take the kernel's plain
PyTorch version, CUDA tensors launch the kernel or raise.
"""
