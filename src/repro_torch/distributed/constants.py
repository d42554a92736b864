"""Production mesh constants of the LM sharding rules.

Port of the mesh half of ``src/repro/distributed/constants.py``. The
production mesh is (data=16, model=16) a pod, (pod=2, data=16, model=16)
across pods. The schema's divisibility rules read these sizes whatever mesh
a run places on (``models/config.py::padded_vocab``, ``distributed/ctx.py::
arch_profile``, the ZeRO-1 dim of ``distributed/lm_sharding.py``); placement
then divides by the run's own axis sizes.

The reference's TPU v5e hardware constants beside them (peak bf16 rate,
HBM and ICI bandwidth) are numbers of another chip and are not carried
over. The H100's come with the cost accounting (ROADMAP.md, queue 1,
item 1, part 5).
"""
DATA_AXIS_SIZE = 16
MODEL_AXIS_SIZE = 16
