"""Launchers of the port: the triangle-count serving front end.

Port of ``src/repro/launch/__init__.py`` for ``TCServer`` (one-shot
requests). LM serving of the dense family is ``launch/serve.py``
(``ServeSession``) over ``launch/steps.py``; the LM trainer, the dry run and
the mesh wait (ROADMAP.md queue 1, item 5).
"""
from repro_torch.launch.tc_serve import ServeConfig, ServeRequest, ServeResult, TCServer

__all__ = ["ServeConfig", "ServeRequest", "ServeResult", "TCServer"]
