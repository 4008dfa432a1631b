"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (port of the fleet-tick, merge, quantized-merge, robust-merge,
single-device core and model-zoo attention kernels of ``repro.kernels``,
and the attention's and the GLA's backwards, which the reference leaves to jnp
and jax's autodiff)."""
from repro_torch.kernels._lib import KERNELS, launch_counts, reset_launch_counts
from repro_torch.kernels.fleet_ingest import (
    fleet_ingest,
    fleet_ingest_paged,
    fleet_ingest_plain,
    validate_shared_basis,
)
from repro_torch.kernels.flash_attn import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from repro_torch.kernels.gla_scan import (
    gla_backward,
    gla_backward_plain,
    gla_forward,
    gla_forward_plain,
)
from repro_torch.kernels.hidden_proj import hidden_proj, hidden_proj_plain
from repro_torch.kernels.matmul_atb import matmul_atb, matmul_atb_plain, uv_accum
from repro_torch.kernels.ops import (
    oselm_step_k1_kernel,
    oselm_step_k1_plain,
    uv_from_batch_kernel,
    uv_from_batch_plain,
    uv_from_state_kernel,
)
from repro_torch.kernels.quantize_pack import quantize_pack, quantize_pack_plain
from repro_torch.kernels.rank1_add import k1_update, k1_update_plain, rank1_add, rank1_add_plain
from repro_torch.kernels.robust_merge import (
    robust_segment_combine,
    robust_segment_sum_mix,
    robust_segment_sum_mix_plain,
)
from repro_torch.kernels.topology_merge import (
    banded_merge_solve,
    banded_merge_solve_plain,
    banded_mix,
    banded_mix_plain,
    dense_mix,
    dense_mix_plain,
    from_uv_solve,
    from_uv_solve_plain,
    masked_segment_sum_mix,
    masked_segment_sum_mix_plain,
    segment_broadcast,
    segment_broadcast_plain,
    segment_sum_mix,
    segment_sum_mix_plain,
    topology_mix,
)

__all__ = [
    "KERNELS", "launch_counts", "reset_launch_counts",
    "fleet_ingest", "fleet_ingest_paged", "fleet_ingest_plain", "validate_shared_basis",
    "banded_merge_solve", "banded_merge_solve_plain",
    "dense_mix", "dense_mix_plain",
    "from_uv_solve", "from_uv_solve_plain",
    "masked_segment_sum_mix", "masked_segment_sum_mix_plain",
    "segment_sum_mix", "segment_sum_mix_plain", "segment_broadcast", "segment_broadcast_plain",
    "banded_mix", "banded_mix_plain", "topology_mix",
    "hidden_proj", "hidden_proj_plain", "matmul_atb", "matmul_atb_plain", "uv_accum",
    "rank1_add", "rank1_add_plain", "k1_update", "k1_update_plain",
    "flash_attention", "flash_attention_plain", "flash_attention_fwd", "flash_attention_bwd",
    "flash_attention_bwd_plain", "gla_forward", "gla_forward_plain", "gla_backward",
    "gla_backward_plain",
    "oselm_step_k1_kernel", "oselm_step_k1_plain", "uv_from_batch_kernel",
    "uv_from_batch_plain", "uv_from_state_kernel",
    "quantize_pack", "quantize_pack_plain",
    "robust_segment_combine", "robust_segment_sum_mix",
    "robust_segment_sum_mix_plain",
]
