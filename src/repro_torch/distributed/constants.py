"""Production mesh constants and the NVIDIA H100's rates for the roofline.

Port of ``src/repro/distributed/constants.py``. The production mesh is
(data=16, model=16) a pod, (pod=2, data=16, model=16) across pods. The
schema's divisibility rules read these sizes whatever mesh a run places on
(``models/config.py::padded_vocab``, ``distributed/ctx.py::arch_profile``,
the ZeRO-1 dim of ``distributed/lm_sharding.py``); placement then divides by
the run's own axis sizes.

The reference's hardware constants are a TPU v5e's; these are the H100 SXM's
under the same names (``analysis/roofline.py`` divides by them), from
NVIDIA's H100 data sheet. The link rate's term has no effect on a mesh of
logical shards of one card, where nothing moves between cards.
"""
DATA_AXIS_SIZE = 16
MODEL_AXIS_SIZE = 16

# NVIDIA H100 SXM per-card hardware constants.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor-core rate
HBM_BW = 3.35e12  # bytes/s, HBM3
# NVLink 4: the data sheet's 900 GB/s counts both directions of the card's
# 18 links; a collective's bytes into one card arrive at half of it.
NVLINK_BW = 450e9  # bytes/s into one card
