#!/usr/bin/env python3
"""Time design variants of the port's selective-scan kernel on the card.

    python3 scripts/mamba_scan_variants.py

Builds ``src/repro_torch/csrc/mamba_scan.cu`` as it stands and with two of
its choices changed by text substitution (lanes per channel: 2 as shipped,
or 4; the exponential: ``ex2.approx`` as shipped, or ``exp2f``), then times
each with CUDA events at the long prefill (B=1, S=2048), the trainer's
reference-inference rows (4 x 80) and 16 x 80, all at D=8192, N=16, and
checks it against the plain version. Needs one CUDA card and ``nvcc``;
prints the card's name and power limit, then one JSON line per variant and
shape. Builds go to ``build/variants/``.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

SHIPPED = {"lanes": "constexpr int MS_SPLIT = 2;",
           "exp": "ex2(dtt * a2[j])"}
VARIANTS = {(2, "ex2.approx"): {},
            (2, "exp2f"): {SHIPPED["exp"]: "exp2f(dtt * a2[j])"},
            (4, "ex2.approx"): {SHIPPED["lanes"]:
                                "constexpr int MS_SPLIT = 4;"},
            (4, "exp2f"): {SHIPPED["lanes"]: "constexpr int MS_SPLIT = 4;",
                           SHIPPED["exp"]: "exp2f(dtt * a2[j])"}}
SHAPES = ((1, 2048, 8192, 16), (4, 80, 8192, 16), (16, 80, 8192, 16))


def build(nvcc, flags, signature):
    src = (ROOT / "src/repro_torch/csrc/mamba_scan.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, subs in VARIANTS.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"variant {key}: {old!r} not in the source")
            text = text.replace(old, new)
        stem = out / f"mamba_scan_{key[0]}_{key[1].replace('.', '_')}"
        stem.with_suffix(".cu").write_text(text)
        procs[key] = (stem, subprocess.Popen(
            [nvcc, *flags, "-o", str(stem.with_suffix(".so")),
             str(stem.with_suffix(".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        fn = ctypes.CDLL(str(stem.with_suffix(".so"))).mamba_scan
        fn.argtypes, fn.restype = signature, ctypes.c_int
        fns[key] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        raise SystemExit("mamba_scan_variants.py: CUDA is not available")
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import mamba_scan_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns = build(_build._nvcc(), _build.NVCC_FLAGS,
                _build.SIGNATURES["mamba_scan"]["mamba_scan"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, S, D, N in SHAPES:
        # the model's ranges: A = -(1..N), dt near softplus(-4.6)
        x = torch.randn((B, S, D), generator=gen, device=dev)
        dt = torch.nn.functional.softplus(
            0.5 * torch.randn((B, S, D), generator=gen, device=dev) - 4.6)
        a = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(
            D, N).contiguous()
        dbc = torch.randn((B, S, 256 + 2 * N), generator=gen, device=dev)
        b, c = dbc[..., 256:256 + N], dbc[..., 256 + N:]
        ref = mamba_scan_ref(x, dt, a, b, c)
        for (lanes, exp), fn in fns.items():
            y = torch.empty_like(x)
            args = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                    c.data_ptr(), y.data_ptr(), B, S, D, N, b.stride(0),
                    b.stride(1), c.stride(0), c.stride(1),
                    torch.cuda.current_stream().cuda_stream)
            _build.check("mamba_scan variant", fn(*args))
            torch.cuda.synchronize()
            err = ((y - ref).abs() / (1 + ref.abs())).max().item()
            for _ in range(5):
                fn(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            print(json.dumps({"B": B, "S": S, "D": D, "N": N,
                              "lanes_per_channel": lanes, "exp": exp,
                              "ms": start.elapsed_time(end) / 20,
                              "max_err_over_1_plus_ref": err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
