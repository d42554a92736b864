"""repro_torch — the TCIM system ported to PyTorch and CUDA for one NVIDIA H100.

A second package beside the JAX reference ``repro``, mirroring its layout
file for file; each module names the reference module it ports. It imports
``torch`` and ``numpy`` and nothing of JAX or of ``repro``. Entry points
run on the card unless the caller passes ``device="cpu"``, which runs the
kernels' plain torch versions. See ROADMAP.md for what is ported so far.
"""
