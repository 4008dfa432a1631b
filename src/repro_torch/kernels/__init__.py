"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (port of the fleet-tick, quantized-merge and robust-merge kernels
of ``repro.kernels``)."""
from repro_torch.kernels._lib import KERNELS, launch_counts, reset_launch_counts
from repro_torch.kernels.fleet_ingest import (
    fleet_ingest,
    fleet_ingest_plain,
    validate_shared_basis,
)
from repro_torch.kernels.quantize_pack import quantize_pack, quantize_pack_plain
from repro_torch.kernels.robust_merge import (
    MAX_TRIM,
    robust_segment_combine,
    robust_segment_sum_mix,
    robust_segment_sum_mix_plain,
)
from repro_torch.kernels.topology_merge import (
    banded_merge_solve,
    banded_merge_solve_plain,
    dense_mix,
    dense_mix_plain,
    from_uv_solve,
    from_uv_solve_plain,
    masked_segment_sum_mix,
    masked_segment_sum_mix_plain,
)

__all__ = [
    "KERNELS", "launch_counts", "reset_launch_counts",
    "fleet_ingest", "fleet_ingest_plain", "validate_shared_basis",
    "banded_merge_solve", "banded_merge_solve_plain",
    "dense_mix", "dense_mix_plain",
    "from_uv_solve", "from_uv_solve_plain",
    "masked_segment_sum_mix", "masked_segment_sum_mix_plain",
    "quantize_pack", "quantize_pack_plain",
    "MAX_TRIM", "robust_segment_combine", "robust_segment_sum_mix",
    "robust_segment_sum_mix_plain",
]
