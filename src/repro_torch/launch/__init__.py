"""Launchers of the port: the triangle-count serving front end.

Port of ``src/repro/launch/__init__.py`` for ``TCServer`` (one-shot
requests). The LM launchers (train, serve, dry run, mesh) come with the LM
substrate (ROADMAP.md queue 1, item 12).
"""
from repro_torch.launch.tc_serve import ServeConfig, ServeRequest, ServeResult, TCServer

__all__ = ["ServeConfig", "ServeRequest", "ServeResult", "TCServer"]
