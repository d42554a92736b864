"""Graph substrate: generators, CSR structures, orientations, exact references.

Port of ``src/repro/graphs/__init__.py``. Everything here is host NumPy
except ``device_orient``/``DeviceGraph`` (torch on the device); the compute
path that consumes these structures lives in ``repro_torch.core`` /
``repro_torch.kernels``.
"""
from repro_torch.graphs.csr import (
    DeviceGraph,
    Graph,
    build_graph,
    degree_order,
    device_orient,
    upper_triangular_edges,
)
from repro_torch.graphs.exact import (
    triangles_bruteforce,
    triangles_dense_trace,
    triangles_intersection,
)
from repro_torch.graphs.generators import (
    GRAPH_GENERATORS,
    barabasi_albert,
    complete_graph,
    erdos_renyi,
    grid_road,
    rmat,
    triangle_free_bipartite,
)

__all__ = [
    "erdos_renyi",
    "rmat",
    "barabasi_albert",
    "grid_road",
    "complete_graph",
    "triangle_free_bipartite",
    "GRAPH_GENERATORS",
    "Graph",
    "DeviceGraph",
    "build_graph",
    "degree_order",
    "device_orient",
    "upper_triangular_edges",
    "triangles_dense_trace",
    "triangles_intersection",
    "triangles_bruteforce",
]
