"""tclint_torch — tclint's hot-path rules for the PyTorch/CUDA port.

``tools.tclint`` scopes every rule to ``repro/...`` modules and reads JAX
idioms. This package runs the same engine (pragmas with mandatory reasons,
fingerprinted baseline, the ``LintResult`` report) over ``src/repro_torch``
with torch sinks:

========  ==============================================================
rule      what it flags
========  ==============================================================
TCL001    implicit host sync in an execute-path module: ``.item()`` /
          ``.tolist()`` / ``.cpu()`` / ``.numpy()`` or ``int()`` /
          ``float()`` / ``bool()`` of a torch-tainted value (seeds:
          ``torch.*`` call results and the resident-store attributes),
          and any ``synchronize()``
TCL002    host->device copy outside ``repro_torch/runtime/staging.py``
          (``stage``, the one copy ``max_transfers`` counts):
          ``.to(<device>)``, ``.cuda()``, ``pin_memory``, ``copy_`` from
          a host value, ``torch.tensor`` / ``torch.as_tensor`` with
          ``device=``
TCL004    int32 overflow: tclint's rule with the port's quantity and
          guard names
TCL006    dead export: a public ``src/repro_torch`` name used nowhere in
          the port, its tests (``tests/test_torch_*.py``), its tools or
          ``chip_smoke.py``
========  ==============================================================

TCL003 (eager variable-bound slices that retrace) and TCL005 (donated
buffers read again) are ``jax.jit`` hazards with no eager-torch
counterpart, so they are not ported.

Run it::

    python -m tools.tclint_torch src/repro_torch

The baseline (``tools/tclint_torch/baseline.json``) is kept empty; a
finding is fixed or carries a ``# tclint: <kw>-ok(<reason>)`` pragma.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Sequence

from tools.tclint import (
    Config,
    LintResult,
    _collect_files,
    _relpath,
    _split,
    load_baseline,
    parse_pragmas,
    save_baseline,
)
from tools.tclint.rules import check_int32_products

__all__ = ["TORCH_CONFIG", "lint_source", "run_lint", "load_baseline", "save_baseline"]

TORCH_CONFIG = Config(
    execute_modules=(
        "repro_torch/core/executor.py",
        "repro_torch/core/build.py",
        "repro_torch/core/streaming.py",
        "repro_torch/distributed/tc.py",
        "repro_torch/distributed/resilient.py",
        "repro_torch/launch/tc_serve.py",
    ),
    transfer_modules=("repro_torch/runtime/staging.py",),
    guard_names=(
        "INT32_SAFE_WORDS",
        "_INT32_MAX",
        "_INT32_LIMIT",
        "clamp_chunk_pairs",
        "iinfo",
        "_CAND_GUARD",
    ),
    export_root="src/repro_torch",
    usage_roots=(
        "src/repro_torch/**/*.py",
        "tests/test_torch_*.py",
        "tools/tclint_torch/*.py",
        "tools/kernel_levers.py",
        "chip_smoke.py",
    ),
)


def lint_source(source: str, path: str, config: Config | None = None) -> tuple[list, int]:
    """Run the per-file rules (TCL001, TCL002, TCL004) over one module's
    source; returns ``(violations, pragma_suppressed_count)``."""
    from tools.tclint_torch import rules

    config = config or TORCH_CONFIG
    tree = ast.parse(source, filename=path)
    raw = (rules.check_host_sync(tree, path, source, config)
           + rules.check_transfers(tree, path, source, config)
           + check_int32_products(tree, path, source, config))
    deduped: dict[tuple, object] = {}
    for v in raw:
        deduped.setdefault((v.rule, v.line, v.col, v.message), v)
    return _split(deduped.values(), parse_pragmas(source))


def run_lint(
    paths: Sequence[str],
    *,
    root: str | Path = ".",
    config: Config | None = None,
    baseline: set[str] | None = None,
    dead_exports: bool = True,
) -> LintResult:
    """Lint ``paths`` (files or directories, relative to ``root``)."""
    from tools.tclint_torch.rules import find_dead_exports

    config = config or TORCH_CONFIG
    rootp = Path(root).resolve()
    files = _collect_files(paths, rootp)
    violations, suppressed = [], 0
    for f in files:
        kept, supp = lint_source(f.read_text(), _relpath(f, rootp), config)
        violations += kept
        suppressed += supp
    if dead_exports:
        dead, supp = find_dead_exports(rootp, config)
        violations += dead
        suppressed += supp
    baseline = baseline or set()
    kept = sorted((v for v in violations if v.fingerprint not in baseline),
                  key=lambda v: (v.path, v.line, v.rule))
    grandfathered = [v for v in violations if v.fingerprint in baseline]
    return LintResult(
        violations=kept,
        baselined=grandfathered,
        suppressed=suppressed,
        stale_baseline=sorted(baseline - {v.fingerprint for v in grandfathered}),
        files_scanned=len(files),
    )
