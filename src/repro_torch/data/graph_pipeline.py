"""Graph dataset pipeline: generate -> orient -> compress -> schedule.

Port of ``src/repro/data/graph_pipeline.py``. Returns (Graph, SBF, Worklist)
for the TC benchmarks; results are cached in-process since generation
dominates for large graphs.
"""
from __future__ import annotations

from repro_torch.configs.tcim_graphs import GraphConfig
from repro_torch.core.sbf import build_sbf, build_worklist
from repro_torch.graphs import GRAPH_GENERATORS, build_graph

__all__ = ["load_graph"]

_CACHE: dict = {}


def load_graph(cfg: GraphConfig, slice_bits: int = 64, reorder: bool = True):
    key = (cfg.name, cfg.n, cfg.m, slice_bits, reorder)
    if key in _CACHE:
        return _CACHE[key]
    gen = GRAPH_GENERATORS[cfg.generator]
    if cfg.generator == "grid_road":
        edges = gen(cfg.n, seed=cfg.seed)
    else:
        edges = gen(cfg.n, cfg.m, seed=cfg.seed)
    g = build_graph(edges, reorder=reorder)
    sbf = build_sbf(g, slice_bits)
    wl = build_worklist(g, sbf)
    _CACHE[key] = (g, sbf, wl)
    return _CACHE[key]
