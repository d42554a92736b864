"""Fixture tests for the port's lint (``tools/tclint_torch``).

Each ported rule (TCL001, TCL002, TCL004, TCL006) gets fixtures that must
fire and fixtures that must stay quiet, plus pragma suppression, the
baseline round trip, and the gate that ``src/repro_torch`` is clean
against the empty baseline. The engine is ``tools.tclint``'s; its own
tests (``tests/test_tclint.py``) are untouched.
"""
from __future__ import annotations

import dataclasses
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.tclint_torch import (  # noqa: E402
    TORCH_CONFIG,
    lint_source,
    load_baseline,
    run_lint,
    save_baseline,
)
from tools.tclint_torch.__main__ import main as lint_main  # noqa: E402

# An execute-path module of the port, NOT the staging module, so the
# scoped rules apply and TCL002 fires too.
EXEC_PATH = "src/repro_torch/core/streaming.py"


def lint(src: str, path: str = EXEC_PATH):
    violations, suppressed = lint_source(textwrap.dedent(src), path)
    return [v.rule for v in violations], suppressed


# ---------------------------------------------------------------- TCL001


@pytest.mark.parametrize("expr", [
    "torch.sum(x).item()",
    "torch.cumsum(x, 0).tolist()",
    "self.row_data.cpu()",
    "self.col_data[idx].numpy()",
    "int(torch.sum(x))",
    "float(self.row_data.sum())",
    "bool((self.col_data == 0).all())",
    "torch.cuda.synchronize()",
    "stream.synchronize()",
])
def test_tcl001_fires_on_torch_readback(expr):
    rules, _ = lint(f"""
        import torch

        def f(self, x, idx, stream):
            return {expr}
        """)
    assert rules == ["TCL001"]


def test_tcl001_fires_through_assignments():
    rules, _ = lint("""
        import torch

        def f(x):
            total = torch.zeros(2, dtype=torch.int32)
            total += x
            host = total
            return host.tolist()
        """)
    assert rules == ["TCL001"]


def test_tcl001_quiet_on_host_values_and_metadata():
    rules, _ = lint("""
        import numpy as np
        import torch

        def f(self, xs):
            n = int(np.sum(xs))                       # numpy is host data
            k = int(self.row_data.shape[0])           # shape metadata
            w = int(self.col_data.numel()) + self.row_data.element_size()
            on_card = self.row_data.device.type == "cuda"
            h = torch.from_numpy(xs).tolist()         # a host tensor
            total = torch.sum(torch.as_tensor(xs))
            return n + k + w, on_card, h, total       # device value returned, not synced
        """)
    assert rules == []


def test_tcl001_quiet_outside_execute_modules():
    rules, _ = lint("""
        import torch

        def f(x):
            return int(torch.sum(x))
        """, path="src/repro_torch/core/metrics.py")
    assert rules == []


# ---------------------------------------------------------------- TCL002


@pytest.mark.parametrize("stmt", [
    "t.to(device)",
    "t.to(self.device, non_blocking=True)",
    "t.to('cuda')",
    "t.to(torch.device('cuda', 0))",
    "t.to(device=dev, dtype=torch.int32)",
    "t.cuda()",
    "t.pin_memory()",
    "torch.empty((2, 4), dtype=torch.int32, pin_memory=True)",
    "out.copy_(torch.from_numpy(a))",
    "out.copy_(np.zeros(4))",
    "torch.tensor([1, 2], device=dev)",
    "torch.as_tensor(a, dtype=torch.int32, device=dev)",
])
def test_tcl002_fires_on_host_to_device_copy(stmt):
    rules, _ = lint(f"""
        import numpy as np
        import torch

        def f(self, t, a, out, device, dev):
            return {stmt}
        """)
    assert rules == ["TCL002"]


def test_tcl002_fires_on_copy_from_a_host_name():
    rules, _ = lint("""
        import numpy as np
        import torch

        def f(out, a):
            host = torch.from_numpy(np.ascontiguousarray(a)).view(torch.int32)
            out.copy_(host)
        """)
    assert rules == ["TCL002"]


def test_tcl002_quiet_on_dtype_casts_and_device_work():
    rules, _ = lint("""
        import torch

        def f(t, out, other, dtype, dev):
            a = t.to(torch.int32)
            b = t.to(dtype)
            out.copy_(other)                              # device to device
            c = torch.zeros(4, dtype=torch.int32, device=dev)  # allocated there
            d = torch.tensor([1, 2])                      # stays on the host
            return a, b, c, d
        """)
    assert rules == []


def test_tcl002_quiet_in_the_staging_module():
    rules, _ = lint("""
        def stage(t, device):
            return t.pin_memory().to(device, non_blocking=True)
        """, path="src/repro_torch/runtime/staging.py")
    assert rules == []


# ---------------------------------------------------------------- TCL004


def test_tcl004_fires_on_unguarded_quantity_product():
    rules, _ = lint("""
        def worst(num_pairs, words_per_slice):
            return num_pairs * words_per_slice * 32
        """)
    assert rules == ["TCL004"]


@pytest.mark.parametrize("guard", ["INT32_SAFE_WORDS", "_INT32_LIMIT", "clamp_chunk_pairs"])
def test_tcl004_quiet_when_guard_in_scope(guard):
    rules, _ = lint(f"""
        def worst(num_pairs, words_per_slice):
            assert num_pairs * words_per_slice <= {guard}
            return num_pairs * words_per_slice
        """)
    assert rules == []


def test_jit_rules_are_not_ported():
    """TCL003 (eager variable slices) and TCL005 (donation) are jax.jit
    hazards: an eager slice and a reused argument stay quiet here."""
    rules, _ = lint("""
        import torch

        def f(self, lo, hi, acc, step):
            window = self.row_data[lo:hi]
            acc = step(window, acc)
            return torch.zeros(7), acc
        """)
    assert rules == []


# ---------------------------------------------------------------- TCL006


@pytest.fixture
def export_tree(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "sub").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "sub" / "__init__.py").write_text(
        "from repro_torch.sub.mod import reexported_only\n"
        "__all__ = ['reexported_only']\n"
    )
    (pkg / "sub" / "mod.py").write_text(textwrap.dedent("""
        __all__ = ["used_by_smoke", "used_by_test", "helper_of_live", "dead",
                   "reexported_only", "excused"]

        def helper_of_live():
            return 1

        def used_by_smoke():
            return helper_of_live()

        def used_by_test():
            return 2

        def dead():
            return 3

        def reexported_only():
            return 4

        # tclint: export-ok(kept for a fixture reason)
        def excused():
            return 5
        """))
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_x.py").write_text(
        "from repro_torch.sub.mod import used_by_test\n")
    # A reference test is not a usage root of the port.
    (tmp_path / "tests" / "test_other.py").write_text("dead = 1\n")
    (tmp_path / "chip_smoke.py").write_text(
        "from repro_torch.sub.mod import used_by_smoke\nused_by_smoke()\n")
    return tmp_path


def test_tcl006_fires_on_dead_export_and_honors_liveness(export_tree):
    result = run_lint(["src"], root=export_tree)
    dead = sorted(v.snippet for v in result.violations if v.rule == "TCL006")
    assert dead == ["def-or-assign dead", "def-or-assign reexported_only"]
    assert result.suppressed == 1  # the pragma'd export


def test_tcl006_chip_smoke_is_a_usage_root(export_tree):
    (export_tree / "chip_smoke.py").write_text("print('nothing of the port')\n")
    config = dataclasses.replace(TORCH_CONFIG, usage_roots=("src/repro_torch/**/*.py",
                                                            "tests/test_torch_*.py"))
    for cfg in (TORCH_CONFIG, config):
        result = run_lint(["src"], root=export_tree, config=cfg)
        dead = {v.snippet for v in result.violations if v.rule == "TCL006"}
        assert "def-or-assign used_by_smoke" in dead
        assert "def-or-assign helper_of_live" in dead  # dies with its only caller


# ------------------------------------------------------- pragmas, baseline


def test_pragma_suppresses_with_reason_only():
    src = """
        import torch

        def f(x):
            return torch.sum(x).item()  # tclint: sync-ok(fixture close)
    """
    rules, suppressed = lint(src)
    assert rules == [] and suppressed == 1
    rules, suppressed = lint(src.replace("(fixture close)", "()"))
    assert rules == ["TCL001"] and suppressed == 0


def test_pragma_on_line_above_suppresses():
    rules, suppressed = lint("""
        def f(t, device):
            # tclint: transfer-ok(fixture upload)
            return t.to(device)
        """)
    assert rules == [] and suppressed == 1


def test_baseline_round_trip_and_stale_reporting(tmp_path):
    src = textwrap.dedent("""
        import torch

        def f(x):
            return int(torch.sum(x))
        """)
    f = tmp_path / "src" / "repro_torch" / "core" / "executor.py"
    f.parent.mkdir(parents=True)
    f.write_text(src)
    first = run_lint([str(f)], root=tmp_path, dead_exports=False)
    assert [v.rule for v in first.violations] == ["TCL001"]

    bl = tmp_path / "baseline.json"
    save_baseline(bl, [v.fingerprint for v in first.violations])
    entries = load_baseline(bl)
    second = run_lint([str(f)], root=tmp_path, baseline=entries, dead_exports=False)
    assert second.ok and len(second.baselined) == 1

    # Fix the code: the entry goes stale and is reported for removal.
    f.write_text(src.replace("int(torch.sum(x))", "torch.sum(x)"))
    third = run_lint([str(f)], root=tmp_path, baseline=entries, dead_exports=False)
    assert third.ok and third.stale_baseline == sorted(entries)


# ------------------------------------------------------------- repo gate


def test_port_is_clean_against_empty_baseline():
    baseline = load_baseline(REPO / "tools" / "tclint_torch" / "baseline.json")
    assert baseline == set(), "baseline must stay empty: pragma new exceptions"
    result = run_lint(["src/repro_torch"], root=REPO, baseline=baseline)
    assert result.ok, "\n".join(
        f"{v.path}:{v.line}: {v.rule} {v.message}" for v in result.violations
    )
    assert result.files_scanned > 50


def test_cli_exits_zero_on_the_port(capsys):
    assert lint_main(["src/repro_torch", "--root", str(REPO)]) == 0
    assert "tclint_torch: 0 violation(s)" in capsys.readouterr().out
