"""Analytical latency/energy model of the TCIM accelerator (paper §V).

Port of ``src/repro/core/energymodel.py``: a copy (pure Python), kept here
because the port imports nothing of the JAX package.

The paper drives a device-to-architecture stack (Brinkman/LLG MTJ model ->
Verilog-A 1T1R cell -> NVSim array -> Java behavioral simulator). We cannot
re-run NVSim offline, so this module implements the *behavioral* layer with
documented per-op constants of NVSim-class 45nm STT-MRAM arrays; the paper's
own Table V / Fig. 6 numbers are carried alongside as the reference columns
in the benchmark output (benchmarks/table5_runtime.py, fig6_energy.py).

Model (all per 64-bit slice granularity, matching |S| = 64):

  latency  = pairs * (t_and + t_count) + misses * t_write + edges * t_ctrl
  energy   = pairs * (e_and + e_count) + misses * e_write + edges * e_ctrl

* t_and: simultaneous two-word-line activation + sense (a READ-class op).
* t_count: the 8->256 LUT adder tree, pipelined behind the sense.
* t_write: STT-MRAM write pulse for a miss (column slice load); hits skip it
  — this is exactly the 72% WRITE saving of Fig. 5.
* t_ctrl: data-buffer index handling per edge (valid-pair lookup), the part
  that remains on the memory controller.
"""
from __future__ import annotations

import dataclasses

__all__ = ["MramConstants", "tcim_latency_energy", "PAPER_TABLE5", "FPGA_POWER_W"]


@dataclasses.dataclass(frozen=True)
class MramConstants:
    """Behavioral per-op constants.

    Latency: NVSim-class access times — these land Table V's TCIM column in
    the right range unfitted (e.g. roadNet-PA modeled 0.064 s vs paper
    0.043 s). Energy: the paper reports only the *normalized* 20.6x vs the
    FPGA (Fig. 6), so per-op energies here are SYSTEM-level effective values
    (array + periphery + row drivers + buffer/controller + interface, at
    realistic utilization) fitted to that anchor — three orders above bare
    MTJ device energies, same accounting level as the FPGA's board power.
    """

    # Latency (seconds per op)
    t_and: float = 3.0e-9  # double-WL read + AND sense, 64 bits parallel
    t_count: float = 0.5e-9  # pipelined LUT BitCount effective cost
    t_write: float = 10.0e-9  # STT write pulse per 64-bit slice (one WL)
    t_ctrl: float = 15.0e-9  # buffer/index handling per edge
    # Energy (joules per op) — system-level effective, Fig.6-anchored.
    e_and: float = 60.0e-9
    e_count: float = 15.0e-9
    e_write: float = 250.0e-9
    e_ctrl: float = 40.0e-9


DEFAULT_CONSTANTS = MramConstants()

FPGA_POWER_W = 25.0  # Huang et al. HPEC'18 FPGA TC accelerator, board power


def tcim_latency_energy(
    num_pairs: int,
    misses: int,
    edges: int,
    constants: MramConstants = DEFAULT_CONSTANTS,
) -> tuple[float, float]:
    """Behavioral TCIM estimate -> (seconds, joules)."""
    c = constants
    latency = num_pairs * (c.t_and + c.t_count) + misses * c.t_write + edges * c.t_ctrl
    energy = num_pairs * (c.e_and + c.e_count) + misses * c.e_write + edges * c.e_ctrl
    return latency, energy


# Paper Table V (seconds). None == N/A in the paper.
PAPER_TABLE5 = {
    # dataset:          (CPU,     GPU,    FPGA,   w/o PIM,  TCIM)
    "ego-facebook": (5.399, 0.150, 0.093, 0.169, 0.005),
    "email-enron": (9.545, 0.146, 0.220, 0.800, 0.021),
    "com-amazon": (20.344, None, None, 0.295, 0.011),
    "com-dblp": (20.803, None, None, 0.413, 0.027),
    "com-youtube": (61.309, None, None, 2.442, 0.098),
    "roadnet-pa": (77.320, 0.169, 1.291, 0.704, 0.043),
    "roadnet-tx": (94.379, 0.173, 1.586, 0.789, 0.053),
    "roadnet-ca": (146.858, 0.180, 2.342, 3.561, 0.081),
    "com-livejournal": (820.616, None, None, 33.034, 2.006),
}
