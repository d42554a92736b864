"""Launchers of the port: the triangle-count serving front end.

Port of ``src/repro/launch/__init__.py`` for ``TCServer`` (one-shot
requests, hosted streams, the write-ahead log ``StreamWAL``, checkpoint and
restore). LM serving of every decoder family is ``launch/serve.py``
(``ServeSession``) over ``launch/steps.py``, and LM training is
``launch/train.py`` (``TrainLoop``, ``run_with_auto_resume``) over
``make_train_step``, both on one device or on a mesh of (logical) shards;
``launch/mesh.py`` builds the meshes and ``launch/specs.py`` the
meta-device inputs of every cell; ``launch/dryrun.py`` counts every cell's
device step on the production meshes without a device.
"""
from repro_torch.launch.tc_serve import (
    ServeConfig,
    ServeRequest,
    ServeResult,
    StreamWAL,
    TCServer,
)

__all__ = ["ServeConfig", "ServeRequest", "ServeResult", "StreamWAL", "TCServer"]
