"""Dry-run sweep: every (arch x shape x mesh) as a subprocess
(isolated process group + memory), resumable via the output directory.

  PYTHONPATH=src python -m repro_torch.launch.sweep --out-dir results/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCHS = [
    "recurrentgemma_9b", "stablelm_12b", "minicpm3_4b", "grok_1_314b",
    "whisper_tiny", "minicpm_2b", "qwen1_5_32b", "falcon_mamba_7b",
    "deepseek_v2_236b", "internvl2_26b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = ["single", "pod"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="results/dryrun")
    ap.add_argument("--meshes", default="single,pod")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    combos = [(a, s, m)
              for m in args.meshes.split(",")
              for a in args.archs.split(",")
              for s in args.shapes.split(",")]
    t0 = time.time()
    n_ok = n_fail = n_skip = 0
    for i, (arch, shape, mesh) in enumerate(combos):
        out = os.path.join(args.out_dir, f"{arch}__{shape}__{mesh}.json")
        if os.path.exists(out):
            try:
                with open(out) as f:
                    st = json.load(f).get("status")
            except (OSError, ValueError):
                st = None
            if st in ("ok", "skipped"):
                print(f"[{i+1}/{len(combos)}] cached {arch} {shape} "
                      f"{mesh}: {st}", flush=True)
                n_ok += st == "ok"
                n_skip += st == "skipped"
                continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", out]
        t1 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            if os.path.exists(out):
                with open(out) as f:
                    st = json.load(f).get("status", f"rc={r.returncode}")
            else:
                with open(out, "w") as f:
                    json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                               "status": "error",
                               "error": (r.stderr or "")[-2000:]}, f)
                st = "error"
        except subprocess.TimeoutExpired:
            with open(out, "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "error", "error": "timeout"}, f)
            st = "timeout"
        dt = time.time() - t1
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_fail += st not in ("ok", "skipped")
        print(f"[{i+1}/{len(combos)}] {arch} {shape} {mesh}: {st} "
              f"({dt:.0f}s, total {time.time()-t0:.0f}s)", flush=True)
    print(f"DONE ok={n_ok} skipped={n_skip} failed={n_fail}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
