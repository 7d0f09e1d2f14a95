#!/usr/bin/env python3
"""Build and time design variants of the bf16 ``decode_attention`` kernel.

    python3 scripts/decode_attention_variants.py

Builds ``src/repro_torch/csrc/decode_attention.cu`` as it stands and with
one of its choices changed by text substitution each:

- ``shipped``: as in the source (64-key tiles, a ring as deep as leaves
  two blocks an SM, masked keys not read, the splits merged in a cluster,
  one launch);
- ``bk32``, ``bk128``: tiles of 32 or 128 keys (2 or 8 warps a block);
- ``stages2``: a ring of at most 2 stages; ``stages4``: of 4 where one
  block an SM has room for them (shipped: 3 at hd 128, 2 at hd 160, 3 at
  hd 256);
- ``no_skip``: every tile and row of a split copied, masked or not (the
  mask still weighs them 0);
- ``two_launches``: no cluster; each block writes its state to device
  memory and a second kernel merges the splits. This variant has no path
  for a row without a valid key, so it is timed only on rows that hold one;
- ``stamps``: the shipped kernel with thread 0 of each block writing the
  SM clock (``%globaltimer``) at the end of each phase: start, Q copies
  issued, mask window built, first tile landed, tiles done, warps' states
  folded, cluster barrier passed, output merged, end. After each shape it
  prints the phases' mean and longest time over the blocks and the spread
  of the blocks' starts (a second wave shows there).

For each it prints the registers and spills from ``ptxas -v`` and the HMMA
and local-memory instructions in the SASS of the bf16 instantiations, then
checks it against the plain version (bf16 bar 2e-2 + 2e-2 |ref|) and times
it at Qwen2.5-7B's decode (B=4, S=2080, 28/4 heads, hd 128, the slots
partly filled and full), StableLM-2-12B's (32/8 heads, hd 160, partly
filled) and RecurrentGemma-9B's (B=4, 16/1 heads, hd 256, a full ring of
2048 and one of 80 keys): the device time per call from ``torch.profiler``
(the kernels alone) and the time per call by CUDA events over back-to-back
calls of the C entry (host included), inputs cycled past L2. Needs one
CUDA card, ``nvcc`` and ``cuobjdump``; prints the card's name and power
limit, then one JSON line per variant and one per variant and shape.
Builds go to ``build/variants/``.
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

KERNEL_HEAD = ("template <typename T, int HD, bool PAGED>\n__global__ void "
               "__launch_bounds__(NT)\ndecode_kernel(")
CLUSTER_MERGE = (
    "  const bool any = run_pass(c, false);\n",
    "  cluster.sync();                 // no block leaves while others read "
    "it\n}\n")
TWO_LAUNCH_TAIL = """  run_pass(c, false);
  __syncthreads();
  float* gp = g_part + ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) *
                        nsplit + split) * C::STATE;
  for (int i = threadIdx.x; i < C::STATE; i += NT) gp[i] = c.part[i];
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
decode_merge(T* __restrict__ out, int H, int KVH, int nsplit) {
  using C = Cfg<T, HD>;
  const int b = blockIdx.y, G = H / KVH, ngroups = (G + GM - 1) / GM;
  const int kvh = blockIdx.x / ngroups, grp = blockIdx.x % ngroups;
  const int h0 = kvh * G + grp * GM, ng = min(GM, G - grp * GM);
  const float* base = g_part + (size_t)(b * gridDim.x + blockIdx.x) *
                                   nsplit * C::STATE;
  for (int i = threadIdx.x; i < ng * HD; i += NT) {
    const int row = i / HD;
    float mx = NEG_INF;
    for (int r = 0; r < nsplit; ++r)
      mx = fmaxf(mx, base[r * C::STATE + GM * HD + row]);
    float a = 0.f, ls = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const float* p = base + r * C::STATE;
      const float f = fast_exp2(p[GM * HD + row] - mx);
      a += p[i] * f;
      ls += p[GM * HD + GM + row] * f;
    }
    out[((size_t)b * H + h0) * HD + i] = from_float<T>(a / fmaxf(ls, 1e-30f));
  }
}
"""
LAUNCH_TAIL = """  return (int)cudaLaunchKernelEx(
      &cfg, decode_kernel<T, HD, PAGED>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid),
      static_cast<const long long*>(table), static_cast<T*>(out), S, H, KVH,
      chunk, ps, scale_log2);
}
"""
TWO_LAUNCH_LAUNCH = """  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_kernel<T, HD, PAGED>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid),
      static_cast<const long long*>(table), static_cast<T*>(out), S, H, KVH,
      chunk, ps, scale_log2);
  if (e != cudaSuccess) return (int)e;
  decode_merge<T, HD><<<dim3(KVH * ngroups, B), NT, 0, st>>>(
      static_cast<T*>(out), H, KVH, nsplit);
  return 0;
}
"""
STAMP = ("if (threadIdx.x == 0) g_ts[(blockIdx.z * gridDim.y + blockIdx.y) * "
         "gridDim.x + blockIdx.x][{}] = hopper::global_ns();")
STAMPS = {
    "namespace repro_torch {\nnamespace {":
        "namespace repro_torch {\n__device__ unsigned long long "
        "g_ts[8192][9];\nnamespace {",
    "  extern __shared__ __align__(16) uint8_t smem[];\n":
        "  extern __shared__ __align__(16) uint8_t smem[];\n  "
        + STAMP.format(0) + "\n",
    "  const bool any = run_pass(c, false);\n":
        "  " + STAMP.format(1) + "\n  const bool any = run_pass(c, false);"
        "\n",
    "    const int n = build_window(c, w0, uniform, any);\n":
        "    const int n = build_window(c, w0, uniform, any);\n"
        "    if (!uniform && w0 == c.lo) " + STAMP.format(2) + "\n",
    "      const int t = c.list[i], s = i % STAGES;\n":
        "      if (i == 0 && !uniform && w0 == c.lo) " + STAMP.format(3)
        + "\n      const int t = c.list[i], s = i % STAGES;\n",
    "  cp_async_wait<0>();\n  __syncthreads();\n\n":
        "  cp_async_wait<0>();\n  __syncthreads();\n  if (!uniform) "
        + STAMP.format(4) + "\n\n",
    "  if (threadIdx.x == 0) c.flag[0] = any;\n":
        "  if (threadIdx.x == 0) c.flag[0] = any;\n  " + STAMP.format(5)
        + "\n",
    "  bool row_any = false;\n":
        "  " + STAMP.format(6) + "\n  bool row_any = false;\n",
    "  cluster.sync();                 // no block leaves while others read "
    "it\n}\n":
        "  " + STAMP.format(7) + "\n  cluster.sync();\n  " + STAMP.format(8)
        + "\n}\n",
    "extern \"C\" int decode_attention(":
        "extern \"C\" int read_stamps(void* dst) {\n  return (int)"
        "cudaMemcpyFromSymbol(dst, repro_torch::g_ts, "
        "sizeof(repro_torch::g_ts));\n}\n\nextern \"C\" int "
        "decode_attention(",
}
PHASES = ("q_issued", "mask_built", "first_tile", "tiles_done", "folded",
          "barrier", "merged", "end")
VARIANTS = {
    "shipped": {},
    "bk32": {"constexpr int BK = 64; ": "constexpr int BK = 32; "},
    "bk128": {"constexpr int BK = 64; ": "constexpr int BK = 128; "},
    "stages2": {"constexpr int MAX_STAGES = 4;":
                "constexpr int MAX_STAGES = 2;"},
    "stages4": {"constexpr int PAIR_BUDGET = 105 * 1024;":
                "constexpr int PAIR_BUDGET = 0;"},
    "no_skip": {"constexpr bool SKIP_MASKED = true;":
                "constexpr bool SKIP_MASKED = false;"},
    "two_launches": {
        KERNEL_HEAD: "__device__ float g_part[8 * 64 * (GM * 256 + 2 * GM)];"
                     "\n\n" + KERNEL_HEAD,
        CLUSTER_MERGE: TWO_LAUNCH_TAIL,
        "  cluster[0].val.clusterDim.x = nsplit;":
            "  cluster[0].val.clusterDim.x = 1;",
        LAUNCH_TAIL: TWO_LAUNCH_LAUNCH},
    "stamps": STAMPS,
}
# (B, S, H, KVH, hd, fill): "part" fills the slots like the smoke's timed
# row (seeded), "full" fills every key
SHAPES = ((4, 2080, 28, 4, 128, "part"), (4, 2080, 28, 4, 128, "full"),
          (4, 2080, 32, 8, 160, "part"), (4, 2048, 16, 1, 256, "full"),
          (4, 80, 16, 1, 256, "full"))
SETS = 8          # input copies cycled per timing, past the 50 MB L2


def substitute(text, subs):
    for old, new in subs.items():
        if isinstance(old, tuple):        # a span from old[0] to old[1]
            i, j = text.find(old[0]), text.find(old[1])
            if i < 0 or j < i:
                raise SystemExit(f"span {old[0]!r} not in the source")
            text = text[:i] + new + text[j + len(old[1]):]
        elif old not in text:
            raise SystemExit(f"{old!r} not in the source")
        else:
            text = text.replace(old, new)
    return text


def build(nvcc, flags, signature):
    src = (ROOT / "src/repro_torch/csrc/decode_attention.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    for header in (ROOT / "src/repro_torch/csrc").glob("*.cuh"):
        shutil.copy(header, out)
    procs = {}
    for name, subs in VARIANTS.items():
        stem = out / f"decode_attention_{name}"
        stem.with_suffix(".cu").write_text(substitute(src, subs))
        procs[name] = (stem, subprocess.Popen(
            [nvcc, *flags, "-o", str(stem.with_suffix(".so")),
             str(stem.with_suffix(".cu"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(stem.with_suffix(".so")))
        fn = lib.decode_attention
        fn.argtypes, fn.restype = signature, ctypes.c_int
        fn.lib = lib
        fns[name] = fn
        print(json.dumps({"variant": name,
                          **report(log, stem.with_suffix(".so"))}))
    return fns


def instance(mangled):
    hd = re.search(r"Li(\d+)E", mangled).group(1)
    return (("bf16" if "bfloat16" in mangled else "fp32") + "_hd" + hd
            + ("_paged" if "Lb1E" in mangled else ""))


def report(log, lib):
    """Per bf16 instantiation of the main kernel: ptxas registers and
    spills, and SASS instruction counts."""
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+decode_kernel\S+)'",
                      line)
        if not m or "bfloat16" not in m.group(1):
            continue
        text = " ".join(lines[i + 1:i + 4])
        out[instance(m.group(1))] = {
            "registers": int(re.search(r"Used (\d+) registers",
                                       text).group(1)),
            "spill_stores": int(re.search(r"(\d+) bytes spill stores",
                                          text).group(1))}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        if "decode_kernel" in name and "bfloat16" in name:
            out[instance(name)].update(
                hmma=part.count("HMMA"),
                local=len(re.findall(r"\b(STL|LDL)", part)))
    return out


def phase_stamps(fn, call, blocks):
    """Per phase, the mean and longest µs over the blocks of one call
    that streamed a tile, and the spread of all the blocks' starts."""
    call(0)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (8192 * 9))()
    _check = fn.lib.read_stamps(buf)
    if _check:
        raise SystemExit(f"read_stamps: CUDA error {_check}")
    rows = [[buf[b * 9 + i] for i in range(9)] for b in range(blocks)]
    t0 = min(r[0] for r in rows)
    spread = max(r[0] - t0 for r in rows) / 1e3
    # a block whose split lists no tile writes no "first tile" stamp: its
    # slot keeps an older call's, out of order; keep the blocks that
    # streamed a tile
    rows = [r for r in rows if all(r[i] <= r[i + 1] for i in range(8))]
    gaps = [[(r[i + 1] - r[i]) / 1e3 for r in rows] for i in range(8)]
    return {"blocks": blocks, "blocks_with_tiles": len(rows),
            "start_spread_us": spread,
            "end_us": max(r[8] - t0 for r in rows) / 1e3,
            **{f"{p}_mean_us": sum(g) / len(g) for p, g in zip(PHASES, gaps)},
            **{f"{p}_max_us": max(g) for p, g in zip(PHASES, gaps)}}


def device_us(fn, calls):
    """Device time per call of the kernels ``fn`` launches, from the
    profiler's kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "decode_" in e.key)
    return us / calls


def event_ms(fn, calls):
    for i in range(calls):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(calls):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main():
    if not torch.cuda.is_available():
        raise SystemExit("decode_attention_variants.py: CUDA is not "
                         "available")
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.decode_attention.ops import _num_sms, _splits
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns = build(_build._nvcc(), _build.NVCC_FLAGS,
                _build.SIGNATURES["decode_attention"]["decode_attention"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B, S, H, KVH, hd, fill in SHAPES:
        if fill == "part":
            lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        else:
            lens = torch.full((B,), S, device=dev)
        valid = torch.arange(S, device=dev)[None, :] < lens[:, None]
        sets = [tuple(torch.randn(shape, generator=gen, device=dev)
                      .bfloat16() for shape in ((B, 1, H, hd),
                                                (B, S, KVH, hd),
                                                (B, S, KVH, hd)))
                for _ in range(SETS)]
        outs = [torch.empty_like(s[0]) for s in sets]
        nsplit, chunk = _splits(_num_sms(dev.index), B, S, H, KVH)
        ref = decode_attention_ref(*sets[0], valid).float()
        nbytes = (2 * B * H * hd + 2 * int(valid.sum()) * KVH * hd) * 2 \
            + B * S
        for name, fn in fns.items():
            def call(i):
                q, k, v = sets[i % SETS]
                _build.check("decode_attention variant", fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    valid.data_ptr(), outs[i % SETS].data_ptr(), B, S, H,
                    KVH, hd, nsplit, chunk, 1, stream))
            call(0)
            torch.cuda.synchronize()
            diff = (outs[0].float() - ref).abs()
            dev_us = device_us(call, 50)
            if name == "stamps":
                print(json.dumps({
                    "variant": name, "B": B, "S": S, "H": H, "KVH": KVH,
                    "hd": hd, **phase_stamps(fn, call, nsplit * B * KVH * (
                        -(-(H // KVH) // 16)))}))
            print(json.dumps({
                "variant": name, "B": B, "S": S, "H": H, "KVH": KVH,
                "hd": hd, "filled": lens.tolist(), "nsplit": nsplit,
                "chunk": chunk, "device_us": dev_us,
                "entry_ms": event_ms(call, 100),
                "bound_us": nbytes / 3.35e12 * 1e6,
                "max_abs_err": diff.max().item(),
                "within_bar": bool((diff <= 2e-2 + 2e-2 * ref.abs())
                                   .all().item())}))
        del sets, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
