"""Config registry of the port: the TCIM graph workloads.

Port of the graph half of ``src/repro/configs/__init__.py``; the LM
architecture configs wait for the LM slice.
"""
from repro_torch.configs.tcim_graphs import GRAPHS, GraphConfig

__all__ = ["GRAPHS", "GraphConfig"]
