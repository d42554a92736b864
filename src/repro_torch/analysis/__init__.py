"""Cost accounting of the port: the roofline over the H100's constants
(``roofline``), a counted cost of any call (``hlo_cost``), the dry run's
tables (``report``) and the hillclimb cells (``hillclimb``).

Port of ``src/repro/analysis/__init__.py``. ``roofline_terms`` is loaded on
first use: ``models/layers.py`` imports ``analysis.hlo_cost`` for its
``cost_scope``, and the roofline's constants live under ``distributed/``,
whose package imports the count paths.
"""

__all__ = ["roofline_terms"]


def __getattr__(name):
    if name == "roofline_terms":
        from repro_torch.analysis.roofline import roofline_terms

        return roofline_terms
    raise AttributeError(name)
