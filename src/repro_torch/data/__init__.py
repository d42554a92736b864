"""Data pipelines of the port: graph workloads and the synthetic LM stream."""
from repro_torch.data.graph_pipeline import load_graph
from repro_torch.data.tokens import SyntheticLMDataset, batch_iterator

__all__ = ["SyntheticLMDataset", "batch_iterator", "load_graph"]
