"""CLI: ``python -m tools.tclint_torch src/repro_torch``.

Exit status 1 when any finding is neither pragma'd nor baselined; stale
baseline entries are reported but do not fail the run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from tools.tclint_torch import load_baseline, run_lint, save_baseline


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tclint_torch", description="TCIM hot-path invariant linter for the port"
    )
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--baseline", help="JSON baseline of grandfathered findings")
    ap.add_argument("--json", action="store_true", help="emit the full report as JSON")
    ap.add_argument("--write-baseline", metavar="PATH",
                    help="write current findings as the new baseline and exit 0")
    ap.add_argument("--no-dead-exports", action="store_true",
                    help="skip the cross-module TCL006 scan (per-file rules only)")
    ap.add_argument("--root", default=".", help="repo root for relative paths (default: cwd)")
    args = ap.parse_args(argv)

    baseline = load_baseline(args.baseline) if args.baseline else set()
    result = run_lint(args.paths, root=args.root, baseline=baseline,
                      dead_exports=not args.no_dead_exports)
    if args.write_baseline:
        entries = [v.fingerprint for v in result.violations + result.baselined]
        save_baseline(args.write_baseline, entries)
        print(f"wrote {len(entries)} entries to {args.write_baseline}")
        return 0
    if args.json:
        print(json.dumps(result.to_json(), indent=2))
    else:
        for v in result.violations:
            print(f"{v.path}:{v.line}:{v.col}: {v.rule} [{v.scope}] {v.message}")
            print(f"    {v.snippet}")
            print(f"    fingerprint: {v.fingerprint}")
        counts = " ".join(f"{r}={c}" for r, c in result.counts.items())
        print(f"tclint_torch: {len(result.violations)} violation(s) ({counts}) | "
              f"{result.suppressed} pragma-suppressed | {len(result.baselined)} baselined | "
              f"{len(result.stale_baseline)} stale baseline entries | "
              f"{result.files_scanned} files")
        for fp in result.stale_baseline:
            print(f"  stale baseline entry (no longer fires): {fp}")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    raise SystemExit(main())
