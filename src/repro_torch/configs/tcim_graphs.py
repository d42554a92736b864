"""Graph workload configs for the TCIM engine (the paper's own benchmarks).

Port of ``src/repro/configs/tcim_graphs.py``: a NumPy copy,
kept here because the port imports nothing of the JAX package.

SNAP datasets are unavailable offline; each entry pairs the paper's reported
statistics (Table II) with a synthetic generator matched on |V| and |E|.
``scale`` shrinks big graphs so CPU-container benchmark runs stay tractable
while preserving density; the full-size generator settings are kept so the
same configs drive a real cluster run.
"""
from __future__ import annotations

import dataclasses

__all__ = ["GraphConfig", "GRAPHS"]


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    name: str
    generator: str  # key into repro_torch.graphs.GRAPH_GENERATORS
    n: int
    m: int
    seed: int = 0
    # paper-reported reference stats (SNAP), for side-by-side reporting
    paper_vertices: int | None = None
    paper_edges: int | None = None
    paper_triangles: int | None = None

    def scaled(self, scale: float) -> "GraphConfig":
        if scale >= 1.0:
            return self
        return dataclasses.replace(
            self, n=max(64, int(self.n * scale)), m=max(128, int(self.m * scale))
        )


# name -> (generator, paper |V|, paper |E|, paper triangles)
_PAPER = {
    "ego-facebook": ("rmat", 4039, 88234, 1612010),
    "email-enron": ("erdos_renyi", 36692, 183831, 727044),
    "com-amazon": ("rmat", 334863, 925872, 667129),
    "com-dblp": ("rmat", 317080, 1049866, 2224385),
    "com-youtube": ("rmat", 1134890, 2987624, 3056386),
    "roadnet-pa": ("grid_road", 1088092, 1541898, 67150),
    "roadnet-tx": ("grid_road", 1379917, 1921660, 82869),
    "roadnet-ca": ("grid_road", 1965206, 2766607, 120676),
    "com-livejournal": ("rmat", 3997962, 34681189, 177820130),
}

GRAPHS = {
    name: GraphConfig(
        name=name,
        generator=gen,
        n=nv,
        m=ne,
        seed=i,
        paper_vertices=nv,
        paper_edges=ne,
        paper_triangles=tri,
    )
    for i, (name, (gen, nv, ne, tri)) in enumerate(_PAPER.items())
}

