"""Three-term roofline model from the dry run's records (NVIDIA H100 rates).

Port of ``src/repro/analysis/roofline.py``:

    compute    = FLOPs_per_device / PEAK_FLOPS_BF16
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / NVLINK_BW

over ``distributed/constants.py``. The per-device terms come from
``analysis/hlo_cost.py::step_cost`` (what one device runs). MODEL_FLOPS uses
the 6·N·D convention (N = params, D = tokens; N_active for MoE); inference
steps use 2·N·D (forward only).
"""
from __future__ import annotations

from repro_torch.distributed.constants import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

__all__ = ["roofline_terms", "model_flops"]


def model_flops(kind: str, n_params_active: int, tokens: int) -> float:
    """6ND for training (fwd+bwd), 2ND for inference-only steps."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_params_active * tokens


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
) -> dict:
    compute_s = flops_per_device / PEAK_FLOPS_BF16
    memory_s = bytes_per_device / HBM_BW
    collective_s = collective_bytes_per_device / NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "step_lower_bound_s": bound,  # perfect-overlap execution model
        "step_upper_bound_s": total,  # zero-overlap execution model
    }
