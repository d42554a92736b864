"""The dry run's tables from ``results/dryrun_torch/``.

Port of ``src/repro/analysis/report.py``: ``dryrun_table`` (what a device
holds, against an H100's 80 GB, and what it runs), ``roofline_table`` (the
three terms over the H100's constants, single-pod mesh) and ``summarize``,
printed to stdout:

    PYTHONPATH=src python -m repro_torch.analysis.report

The records are ``launch/dryrun.py``'s: per-device numbers are one distinct
data-parallel shard's step, counted on meta tensors (no device), and the
bytes a device holds are its placed state without activations.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.launch.dryrun import DEVICE_BYTES, RESULTS_DIR

__all__ = ["load_records", "dryrun_table", "roofline_table", "summarize"]


def load_records(results: Path = RESULTS_DIR) -> list:
    return [json.loads(f.read_text()) for f in sorted(Path(results).glob("*.json"))]


def _placed_gb(r) -> float | None:
    m = r.get("memory", {})
    return m["placed_bytes"] / 1e9 if "placed_bytes" in m else None


def dryrun_table(recs) -> str:
    lines = [
        "| arch | shape | mesh | status | count s | placed GB/device | fits 80GB | "
        "flops/dev | bytes/dev | coll bytes/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("kind") == "tc":
            continue
        if r.get("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP: "
                         f"{r['skip_reason']} | — | — | — | — | — | — |")
            continue
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR |"
                         + " — |" * 6)
            continue
        placed = _placed_gb(r)
        fits = "yes" if r.get("fits_80GB") else "NO"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {r['count_s']} | "
            f"{placed:.2f} | {fits} | {r['flops_per_device']:.3e} | "
            f"{r['bytes_per_device']:.3e} | {r['collectives']['total_bytes']:.3e} |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | bound s | "
        "MODEL_FLOPS/counted | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("skipped") or "roofline" not in r or r["mesh"] != "single":
            continue
        rl = r["roofline"]
        ratio = r.get("useful_flops_ratio", 0.0)
        note = "the TC engine's sharded count" if r.get("kind") == "tc" else ""
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.4f} | {rl['memory_s']:.4f} | "
            f"{rl['collective_s']:.4f} | {rl['dominant']} | {rl['step_lower_bound_s']:.4f} | "
            f"{ratio:.3f} | {note} |")
    return "\n".join(lines)


def summarize(recs) -> dict:
    runnable = [r for r in recs if not r.get("skipped") and "roofline" in r
                and r.get("kind") != "tc"]
    skipped = [r for r in recs if r.get("skipped")]
    over = [r for r in runnable if (_placed_gb(r) or 0) * 1e9 > DEVICE_BYTES]
    dominant: dict = {}
    for r in runnable:
        if r["mesh"] == "single":
            d = r["roofline"]["dominant"]
            dominant[d] = dominant.get(d, 0) + 1
    return {
        "runnable": len(runnable),
        "skipped": len(skipped),
        "over_budget": [(r["arch"], r["shape"], r["mesh"]) for r in over],
        "dominant_counts": dominant,
    }


def main(results: Path = RESULTS_DIR) -> None:
    recs = load_records(results)
    print("## §Dry-run\n")
    print(dryrun_table(recs))
    print("\n## §Roofline (single-pod mesh, 256 cards; one data-parallel shard a device)\n")
    print(roofline_table(recs))
    print("\n## Summary\n")
    print(json.dumps(summarize(recs), indent=1))


if __name__ == "__main__":
    main()
