"""Three-term roofline of a dry-run trace; port of ``repro.roofline.analysis``.

    compute    = flops              / (chips × peak FLOP/s)
    memory     = bytes              / (chips × HBM bytes/s)
    collective = collective bytes   / (chips × link bytes/s)

The reference reads its terms off the optimized HLO of a compiled program.
The port runs eagerly and has no HLO: ``roofline.op_costs`` counts the ops
that one rank's step really runs (FLOPs by ``FlopCounterMode``, the bytes
every aten op reads and writes, the bytes each collective of the dry run's
mesh stand-in sends), and ``roofline_from_trace`` turns those per-device
counts into the reference's global figures, per-device × chips.

The rates are the data sheet's for the card the port is written for,
``HW_H100``: an NVIDIA H100 SXM at its 700 W power limit. The reference's
``HW_V5E`` (a TPU's rates) has no counterpart here.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW_H100", "Hardware", "RooflineReport", "roofline_from_trace"]


@dataclasses.dataclass
class Hardware:
    name: str
    peak_flops: float          # per card, dense bf16 on the tensor cores
    hbm_bw: float              # bytes/s per card
    link_bw: float             # bytes/s per card, each way


# NVIDIA's data sheet, H100 SXM at 700 W: 989 TFLOP/s dense bf16, 3.35 TB/s
# of HBM3, NVLink 900 GB/s to the host's other cards, 450 GB/s each way
HW_H100 = Hardware(name="nvidia-h100-sxm-700w", peak_flops=989e12, hbm_bw=3.35e12,
                   link_bw=450e9)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float              # global: per-device × chips (the reference's names)
    hlo_bytes: float
    attn_interior_bytes: float
    coll_bytes: float
    coll_breakdown: dict[str, float]
    model_flops: float
    per_device_memory: dict[str, float]
    hw: Hardware = dataclasses.field(default_factory=lambda: HW_H100)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.hw.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def t_memory_fused_attn(self) -> float:
        """The memory term with the model's kernels in place: the bytes the
        ops inside each kernel's plain version move, past the kernel's own
        operands and results, never reach HBM on the card."""
        return (self.hlo_bytes - self.attn_interior_bytes) / (self.chips * self.hw.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * self.hw.link_bw)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes, "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_memory_fused_attn_s": self.t_memory_fused_attn,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "per_device_memory": self.per_device_memory,
        }


def roofline_from_trace(
    costs,
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    model_flops: float,
    per_device_memory: dict[str, float] | None = None,
    hw: Hardware = HW_H100,
) -> RooflineReport:
    """The report of one rank's counted step (``op_costs.OpCosts``, per
    device) on a mesh of ``chips`` cards: every count scaled by ``chips``
    to the reference's global figures."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=costs.flops * chips, hlo_bytes=costs.bytes * chips,
        attn_interior_bytes=costs.interior_bytes * chips,
        coll_bytes=costs.collective_bytes * chips,
        coll_breakdown={k: v * chips for k, v in costs.collectives_by().items()},
        model_flops=model_flops, per_device_memory=dict(per_device_memory or {}), hw=hw,
    )
