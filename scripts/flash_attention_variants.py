#!/usr/bin/env python3
"""Build and time design variants of the bf16 ``flash_attention`` kernel.

    python3 scripts/flash_attention_variants.py

Builds ``src/repro_torch/csrc/flash_attention.cu`` as it stands and with
one of its choices changed by text substitution each:

- ``shipped``: as in the source;
- ``hd256_bk64``: 64-key K/V tiles in a 2-stage ring at hd 256 (shipped:
  32 keys, 4 stages);
- ``bk64``: 64-key tiles below hd 256 too (shipped: 128);
- ``role_unbroadcast``: the warpgroup index read from ``threadIdx.x``
  instead of broadcast from lane 0 with ``__shfl_sync``;
- ``no_setmaxnreg``: no register hand-over between the warpgroups.

For each it prints the registers, spills and wgmma serialization notes
from ``ptxas -v``, the HGMMA, WARPGROUP.DEPBAR (a wait after a product)
and local-memory instructions in the SASS, then checks it against the
plain version (bf16 bar 2e-2 + 2e-2 |ref|) and times it with CUDA events
at Qwen2.5-7B's prefill (B=1, S=2048, 28/4 heads, hd 128) and at
RecurrentGemma-9B's (B=1, S=4096, 16/1 heads, hd 256, window 2048, and
the trainer's 4 x 80 tokens), inputs warm in L2. Needs one CUDA card,
``nvcc`` and ``cuobjdump``; prints the card's name and power limit, then
one JSON line per variant and one per variant and shape. Builds go to
``build/variants/``.
"""
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

VARIANTS = {
    "shipped": {},
    "hd256_bk64": {
        "static constexpr int BK = HD == 256 ? 32 : HD == 192 ? 64 : 128;":
            "static constexpr int BK = HD == 256 ? 64 : HD == 192 ? 64 : 128;",
        "static constexpr int STAGES = HD == 256 ? 4 : 2;":
            "static constexpr int STAGES = 2;"},
    "bk64": {"static constexpr int BK = HD == 256 ? 32 : HD == 192 ? 64 : 128;":
             "static constexpr int BK = HD == 256 ? 32 : 64;"},
    "role_unbroadcast": {"__shfl_sync(0xffffffffu, threadIdx.x / 128, 0)":
                         "threadIdx.x / 128"},
    "no_setmaxnreg": {"    regs_release<24>();\n": "",
                      "    regs_claim<240>();\n": ""},
}
SHAPES = ((1, 2048, 28, 4, 128, 0), (1, 4096, 16, 1, 256, 2048),
          (4, 80, 16, 1, 256, 2048))


def build(nvcc, flags, signature):
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    for header in (ROOT / "src/repro_torch/csrc").glob("*.cuh"):
        shutil.copy(header, out)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        stem = out / f"flash_attention_{name}"
        stem.with_suffix(".cu").write_text(text)
        procs[name] = (stem, subprocess.Popen(
            [nvcc, *flags, "-o", str(stem.with_suffix(".so")),
             str(stem.with_suffix(".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(stem.with_suffix(".so"))).flash_attention
        fn.argtypes, fn.restype = signature, ctypes.c_int
        fns[name] = fn
        print(json.dumps({"variant": name,
                          **report(log, stem.with_suffix(".so"))}))
    return fns


def report(log, lib):
    """Per bf16 instantiation: ptxas registers, spills and serialization
    notes, and SASS instruction counts."""
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+flash_wgmma\S+)'",
                      line)
        if not m:
            continue
        hd = "hd" + re.search(r"Li(\d+)E", m.group(1)).group(1)
        text = " ".join(lines[i + 1:i + 4])
        out[hd] = {
            "registers": int(re.search(r"Used (\d+) registers",
                                       text).group(1)),
            "spill_stores": int(re.search(r"(\d+) bytes spill stores",
                                          text).group(1)),
            "serialized": [x.split("serialized due to ")[-1].split(
                " for the function")[0].split(" in the function")[0]
                for x in lines if "serialized" in x and m.group(1) in x]}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        if "flash_wgmma" not in part.split()[0]:
            continue
        hd = "hd" + re.search(r"Li(\d+)E", part.split()[0]).group(1)
        out[hd].update(hgmma=part.count("HGMMA"),
                       depbar=part.count("WARPGROUP.DEPBAR"),
                       local=len(re.findall(r"\b(STL|LDL)", part)))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("flash_attention_variants.py: CUDA is not "
                         "available")
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns = build(_build._nvcc(), _build.NVCC_FLAGS,
                _build.SIGNATURES["flash_attention"]["flash_attention"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, S, H, KVH, hd, window in SHAPES:
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).bfloat16()
        k = torch.randn((B, S, KVH, hd), generator=gen,
                        device=dev).bfloat16()
        v = torch.randn((B, S, KVH, hd), generator=gen,
                        device=dev).bfloat16()
        ref = flash_attention_ref(q, k, v, window=window).float()
        out = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, S, H, KVH, hd, window, 1,
                torch.cuda.current_stream().cuda_stream)
        for name, fn in fns.items():
            _build.check("flash_attention variant", fn(*args))
            torch.cuda.synchronize()
            diff = (out.float() - ref).abs()
            ok = bool((diff <= 2e-2 + 2e-2 * ref.abs()).all().item())
            for _ in range(10):
                fn(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(50):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            print(json.dumps({"variant": name, "B": B, "S": S, "H": H,
                              "KVH": KVH, "hd": hd, "window": window,
                              "ms": start.elapsed_time(end) / 50,
                              "max_abs_err": diff.max().item(),
                              "within_bar": ok}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
