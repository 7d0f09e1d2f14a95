#!/usr/bin/env python3
"""Print a Markdown table of a dry-run sweep's records
(``python -m repro_torch.launch.sweep --out-dir DIR``): one row per arch,
one column per input shape, each cell the ``single`` mesh's record then
the ``pod`` mesh's: ``trace_s``, the collective bytes' total,
``argument_bytes_per_rank`` and ``peak_bytes_per_rank`` (GB = 1e9 bytes),
or the status.

  python scripts/dryrun_table.py results/dryrun
"""
import json
import sys
from pathlib import Path

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def cell(rec):
    if rec is None:
        return "not run"
    if rec["status"] != "ok":
        return rec["status"] + (": " + rec["error"][:60] if "error" in rec
                                else "")
    gb = 1e9
    return (f"{rec['trace_s']:.1f} s; "
            f"{rec['collective_bytes']['total'] / gb:.3g}/"
            f"{rec['argument_bytes_per_rank'] / gb:.3g}/"
            f"{rec['peak_bytes_per_rank'] / gb:.3g}")


def main(out_dir):
    recs = {}
    for path in Path(out_dir).glob("*.json"):
        rec = json.loads(path.read_text())
        recs[rec["arch"], rec["shape"], rec["mesh"]] = rec
    archs = sorted({a for a, _, _ in recs})
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("|---|" + "---|" * len(SHAPES))
    for arch in archs:
        cells = [" · ".join(cell(recs.get((arch, s, m)))
                            for m in ("single", "pod")) for s in SHAPES]
        print(f"| {arch} | " + " | ".join(cells) + " |")
    n = {}
    for rec in recs.values():
        n[rec["status"]] = n.get(rec["status"], 0) + 1
    print(f"\n{n}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun")
