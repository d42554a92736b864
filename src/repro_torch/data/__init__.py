"""Data pipelines of the port (graph workloads only in this slice)."""
from repro_torch.data.graph_pipeline import load_graph

__all__ = ["load_graph"]
