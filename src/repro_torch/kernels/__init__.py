"""Kernels of the port: hand-written CUDA for Hopper, each with a plain
torch version beside it (the CPU path and the on-card comparison).

Port of ``src/repro/kernels``. Kernel sources live in ``csrc/`` and are
built by ``_build.py`` on first use; importing this package needs neither
``nvcc`` nor a card.
"""
