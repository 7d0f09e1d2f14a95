#!/usr/bin/env python3
"""Time the vocab pass of ``grpo_logprob`` and ``fused_rl_loss_fwd``.

    python3 scripts/vocab_pass_variants.py [--src DIR] [--rows-only]

Two parts, each printing JSON lines after the card's name and power limit:

- ``rows``: both kernels of the tree at ``DIR`` (default: this checkout;
  another checkout of the repository, e.g. its parent commit unpacked by
  ``git archive``, for an A/B on one card) at chip_smoke.py phase 7's
  bf16 shapes: the trainers' micro-batches (316 rows of the 65,024,
  152,064 and 256,000 vocabs), 4096 rows of 152,064 and 65,024, and 7 rows
  of 259. Each row holds the kernel against its plain version, then gives
  its time through the wrapper and through its C entry alone (CUDA events
  over back-to-back calls, inputs cycled past L2), its kernels' device time
  (``torch.profiler``), ``torch.log_softmax``'s time, the byte bound and
  the blocks a row the entry chose (``nsplit``; 1 for a tree whose entry
  has no split).
- ``variants`` (this checkout only, skipped by ``--rows-only``): the
  forward's source built, by text substitution, with the ring's copies by
  ``cp.async`` (as shipped) or by one ``cp.async.bulk`` a tile on an
  mbarrier, at ring depths 2, 3 and 4 (shipped: 2), and with tiles of 16
  KB instead of 8 (two stages), each checked against
  the plain version and timed at every forced ``nsplit`` (1, 2, 4, 8) at
  the three trainer shapes and 4096 x 152,064: device µs a call from the
  profiler, with ptxas's registers and spills per variant;
  ``cluster_load_balance`` asks for the load-balancing cluster placement.
  Beside them ``probe_no_exp`` (the pass without its exps) and
  ``probe_no_cluster`` (the same splits launched without a cluster and
  not merged), both wrong on purpose and timed only, show how much of the
  time the arithmetic and the cluster hold, and ``stamps``
  (the shipped kernel with thread 0 of each block writing the clock at
  its start, when its first tile lands, after its last tile, after the
  block's merge and after the row's) prints, at 316 rows of 65,024 and
  152,064 and at 4096 of 152,064, each phase's mean and longest µs over
  the blocks of one call, the spread of their starts and the last end.

Needs one CUDA card and ``nvcc``. Builds go to ``DIR/build/kernels/`` and
``build/variants/``.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROW_SHAPES = ((316, 65_024), (316, 152_064), (316, 256_000),
              (4096, 152_064), (4096, 65_024), (7, 259))
VARIANT_SHAPES = ((316, 65_024), (316, 152_064), (316, 256_000),
                  (4096, 152_064))
STAMP = ("if (threadIdx.x == 0) g_ts[blockIdx.x][{}] = "
         "hopper::global_ns();")
# thread 0 of each block stamps the clock (%globaltimer): start, first
# tile landed, last tile done, block merged, row merged (after the cluster
# barrier; for one block a row, at once)
STAMPS_HEADER = {
    "namespace cg = cooperative_groups;\n":
        "namespace cg = cooperative_groups;\n__device__ unsigned long long "
        "g_ts[8192][5];\n",
    "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n":
        "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n  "
        + STAMP.format(0) + "\n",
    "    hopper::cp_async_wait<STAGES - 1>();   // tile i has landed\n":
        "    hopper::cp_async_wait<STAGES - 1>();   // tile i has landed\n"
        "    if (i == 0) " + STAMP.format(1) + "\n",
    "  // merge: within each warp, then across the block's warps in warp 0\n":
        "  " + STAMP.format(2) + "\n  // merge: within each warp, then "
        "across the block's warps in warp 0\n",
    "  if (nsplit == 1) {\n    out = p;\n":
        "  " + STAMP.format(3) + "\n  if (nsplit == 1) {\n    "
        + STAMP.format(4) + "\n    out = p;\n",
    "  cg::this_cluster().sync();\n":
        "  cg::this_cluster().sync();\n  " + STAMP.format(4) + "\n"}
STAMPS_SOURCE = {
    'extern "C" int fused_rl_loss_fwd(':
        'extern "C" int read_stamps(void* dst) {\n  return (int)'
        'cudaMemcpyFromSymbol(dst, repro_torch::g_ts, '
        'sizeof(repro_torch::g_ts));\n}\n\nextern "C" int '
        'fused_rl_loss_fwd('}
PHASES = ("first_tile", "tiles", "block_merge", "row_merge")
STAGES_LINE = "constexpr int STAGES = 2;"
TILE_LINE = "constexpr int TILE_VECS = 2 * ROW_THREADS;"
CP_ASYNC_RING = (
    "  auto issue = [&](int i) {            // each thread copies its own "
    "vectors\n")
# the ring filled by one thread with one cp.async.bulk a tile, counted on
# an mbarrier a stage, and refilled after a block barrier
BULK = {
    "__device__ __forceinline__ void cluster_arrive_relaxed() {":
        "__device__ __forceinline__ void bulk_load(uint32_t dst, const void* "
        "src, uint32_t bytes, uint32_t bar) {\n  asm volatile(\"cp.async."
        "bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
        "[%1], %2, [%3];\\n\" ::\"r\"(dst), \"l\"(src), \"r\"(bytes), "
        "\"r\"(bar) : \"memory\");\n}\n\n"
        "__device__ __forceinline__ void cluster_arrive_relaxed() {",
    (CP_ASYNC_RING, "  for (int i = 0; i < STAGES; ++i) issue(i);\n"):
        "  __shared__ __align__(8) uint64_t full[STAGES];\n"
        "  auto issue = [&](int i) {\n"
        "    if (i >= ntiles) return;\n"
        "    const int st = i % STAGES, a = v0 + i * TILE_VECS;\n"
        "    const uint32_t bytes = 16u * min(TILE_VECS, v1 - a);\n"
        "    const uint32_t bar = hopper::smem_addr(&full[st]);\n"
        "    hopper::mbar_expect_tx(bar, bytes);\n"
        "    bulk_load(ring_addr + st * TILE_VECS * 16, body + (size_t)a * N,"
        " bytes, bar);\n  };\n"
        "  if (tid == 0) {\n"
        "    for (int st = 0; st < STAGES; ++st)\n"
        "      hopper::mbar_init(hopper::smem_addr(&full[st]), 1);\n"
        "    hopper::mbar_init_fence();\n  }\n"
        "  __syncthreads();\n"
        "  if (tid == 0)\n    for (int i = 0; i < STAGES; ++i) issue(i);\n",
    "    hopper::cp_async_wait<STAGES - 1>();   // tile i has landed\n":
        "    hopper::mbar_wait(hopper::smem_addr(&full[st]), (i / STAGES) & 1);"
        "\n",
    "    issue(i + STAGES);                 // into the stage this thread "
    "just read\n":
        "    __syncthreads();\n    if (tid == 0) issue(i + STAGES);\n"}


def ring(stages, bulk=False, vecs=2):
    """Substitutions for a ring of `stages` tiles of `vecs` vectors a
    thread, filled by cp.async or (bulk) cp.async.bulk."""
    subs = dict(BULK) if bulk else {}
    subs[STAGES_LINE] = f"constexpr int STAGES = {stages};"
    subs[TILE_LINE] = f"constexpr int TILE_VECS = {vecs} * ROW_THREADS;"
    return subs, {}


# name: (substitutions in vocab_pass.cuh, in fused_rl_loss.cu); a name
# starting "probe_" computes wrong values on purpose and is timed, not
# checked. cp_async_stages2 is the shipped kernel.
VARIANTS = {f"{copy}_stages{n}": ring(n, copy == "bulk")
            for copy in ("cp_async", "bulk") for n in (2, 3, 4)}
# tiles of 16 KB (4 vectors a thread), two of them in the ring
VARIANTS["cp_async_vecs4_stages2"] = ring(2, vecs=4)
# clusters placed by the load-balancing policy instead of the default
VARIANTS["cluster_load_balance"] = ({
    "  cfg.numAttrs = 1;\n  return static_cast<int>(cudaLaunchKernelEx(":
        "  cudaLaunchAttribute both[2] = {cluster[0], {}};\n"
        "  both[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;"
        "\n  both[1].val.clusterSchedulingPolicyPreference =\n"
        "      cudaClusterSchedulingPolicyLoadBalancing;\n"
        "  cfg.attrs = both;\n  cfg.numAttrs = 2;\n"
        "  return static_cast<int>(cudaLaunchKernelEx("}, {})
# the same splits launched without a cluster and not merged (every block
# writes its own split's values, wrong on purpose): what the cluster
# launch and its merge cost
VARIANTS["probe_no_cluster"] = ({
    "  if (nsplit > 1) cluster_arrive_relaxed();": "",
    "  if (warp != 0 && nsplit == 1) return false;":
        "  if (warp != 0) return false;",
    "  if (nsplit == 1) {\n    out = p;": "  if (true) {\n    out = p;",
    "  cfg.numAttrs = 1;\n  return static_cast<int>(cudaLaunchKernelEx(":
        "  cfg.numAttrs = 0;\n  return static_cast<int>(cudaLaunchKernelEx("},
    {})
# the pass without its exps: how much of the time the arithmetic holds
VARIANTS["probe_no_exp"] = ({"    float e = __expf(x[i] - s.m);\n":
                             "    float e = x[i];\n"}, {})
VARIANTS["stamps"] = (STAMPS_HEADER, STAMPS_SOURCE)
STAMP_SHAPES = ((316, 65_024, (1, 2, 4)), (316, 152_064, (1, 2, 4)),
                (4096, 152_064, (1,)))
SPLITS = (1, 2, 4, 8)
CALLS = 20


def smoke():
    """chip_smoke.py's timing helpers (its inputs, L2-cycled copies,
    event and profiler timers, bound)."""
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    return chip_smoke


def entries(_build, torch, x, t, old, ref, adv):
    """The two C entries as calls of one input set, in the layout of the
    tree's own entries, and the blocks a row they choose."""
    N, V = x.shape
    code = _build.DTYPE_CODES[x.dtype]
    stream = torch.cuda.current_stream().cuda_stream
    g, f = _build.kernel("grpo_logprob"), _build.kernel("fused_rl_loss_fwd")
    if "vocab_nsplit" in _build.SIGNATURES["grpo_logprob"]:
        out = torch.empty((6, N), dtype=torch.float32, device=x.device)
        return (lambda x, t, *r: g(x.data_ptr(), t.data_ptr(),
                                   out.data_ptr(), N, V, 0, code, stream),
                lambda x, t, o, r, a, *_: f(
                    x.data_ptr(), t.data_ptr(), o.data_ptr(), r.data_ptr(),
                    a.data_ptr(), out.data_ptr(), N, V, 0, 0.2, code,
                    stream),
                _build.kernel("vocab_nsplit")(N, V, code))
    outs = [torch.empty(N, dtype=torch.float32, device=x.device)
            for _ in range(6)]
    ptrs = [o.data_ptr() for o in outs]
    return (lambda x, t, *r: g(x.data_ptr(), t.data_ptr(), ptrs[0], ptrs[1],
                               N, V, code, stream),
            lambda x, t, o, r, a, *_: f(
                x.data_ptr(), t.data_ptr(), o.data_ptr(), r.data_ptr(),
                a.data_ptr(), *ptrs, N, V, 0.2, code, stream),
            1)


def rows(cs, torch, src):
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_rl_loss import (fused_rl_loss_fwd,
                                                   fused_rl_loss_fwd_ref)
    from repro_torch.kernels.grpo_logprob import (grpo_logprob,
                                                  grpo_logprob_ref)
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for N, V in ROW_SHAPES:
        x, t, old, ref, adv, *_ = cs._loss_inputs(torch, gen, N, V,
                                                  torch.bfloat16)
        err = max(cs._check(name, "float32", (N, V), o, r)
                  for name, fn, plain in (
                      ("grpo_logprob", grpo_logprob(x, t),
                       grpo_logprob_ref(x, t)),
                      ("fused_rl_loss_fwd",
                       fused_rl_loss_fwd(x, t, old, ref, adv),
                       fused_rl_loss_fwd_ref(x, t, old, ref, adv)))
                  for o, r in zip(fn, plain))
        sets = cs._copies(torch, (x, t, old, ref, adv))
        g_entry, f_entry, nsplit = entries(_build, torch, x, t, old, ref,
                                           adv)
        nv = N * V
        # host time varies from call to call: many calls, fewer where a
        # call is long
        iters = 50 if N >= 4096 else 500
        for name, wrapper, entry, kname, nbytes in (
                ("grpo_logprob", lambda x, t, *r: grpo_logprob(x, t),
                 g_entry, "grpo_logprob_kernel", 2 * nv + 16 * N),
                ("fused_rl_loss_fwd",
                 lambda x, t, o, r, a: fused_rl_loss_fwd(x, t, o, r, a),
                 f_entry, "fwd_kernel", 2 * nv + 44 * N)):
            bound, by = cs._bound(nbytes, 4 * nv, "float32")
            print("vocab_row", json.dumps(dict(
                tree=src, kernel=name, dtype="bfloat16", N=N, V=V,
                nsplit=nsplit, max_abs_err=err,
                ms=cs._time_ms(torch, wrapper, sets, iters),
                entry_ms=cs._time_ms(torch, entry, sets, iters),
                device_ms=cs._device_ms(torch, wrapper, sets, CALLS, kname),
                library_ms=cs._time_ms(
                    torch, lambda x, *r: torch.log_softmax(x, dim=-1), sets,
                    20),
                bound_ms=bound, bound_by=by)), flush=True)
        del x, t, old, ref, adv, sets
        torch.cuda.empty_cache()


def substitute(text, subs, name):
    """``text`` with each key of ``subs`` replaced (a pair of strings: the
    span from the first to the end of the second)."""
    for old, new in subs.items():
        if isinstance(old, tuple):
            i = text.find(old[0])
            j = text.find(old[1], i)
            if i < 0 or j < 0:
                raise SystemExit(f"{name}: span {old[0]!r} not in the source")
            text = text[:i] + new + text[j + len(old[1]):]
        elif old not in text:
            raise SystemExit(f"{name}: {old!r} not in the source")
        else:
            text = text.replace(old, new)
    return text


def build_variants(_build):
    """Each variant's copy of the sources under build/variants/<name>/,
    built in parallel; returns {name: its fused_rl_loss_fwd entry}."""
    procs = {}
    for name, (header, source) in VARIANTS.items():
        out = ROOT / "build" / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            text = f.read_text()
            (out / f.name).write_text(substitute(text, header, name)
                                      if f.name == "vocab_pass.cuh" else text)
        (out / "fused_rl_loss.cu").write_text(substitute(
            (_build.CSRC / "fused_rl_loss.cu").read_text(), source, name))
        lib = out / "fused_rl_loss.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(out / "fused_rl_loss.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        so = ctypes.CDLL(str(lib))
        fn = so.fused_rl_loss_fwd
        fn.argtypes = _build.SIGNATURES["fused_rl_loss"]["fused_rl_loss_fwd"]
        fn.restype = ctypes.c_int
        fn.lib = so
        fns[name] = fn
        lines = log.splitlines()
        regs = {}
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\S*fwd_kernel\S*)'",
                          line)
            if m:
                text = " ".join(lines[i + 1:i + 4])
                regs["bf16" if "bfloat16" in m.group(1) else "fp32"] = {
                    "registers": int(re.search(r"Used (\d+) registers",
                                               text).group(1)),
                    "spill_stores": int(re.search(
                        r"(\d+) bytes spill stores", text).group(1))}
        print("vocab_variant", json.dumps({"variant": name, **regs}),
              flush=True)
    return fns


def stamps(torch, fn, call, blocks):
    """Per phase, the mean and longest µs over the blocks of one call, the
    spread of the blocks' starts and the last block's end."""
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (8192 * 5))()
    err = fn.lib.read_stamps(buf)
    if err:
        raise SystemExit(f"read_stamps: CUDA error {err}")
    rows = [[buf[b * 5 + i] for i in range(5)] for b in range(blocks)]
    t0 = min(r[0] for r in rows)
    gaps = [[(r[i + 1] - r[i]) / 1e3 for r in rows] for i in range(4)]
    return {"start_spread_us": max(r[0] - t0 for r in rows) / 1e3,
            "end_us": max(r[4] - t0 for r in rows) / 1e3,
            **{f"{p}_mean_us": sum(g) / len(g) for p, g in zip(PHASES, gaps)},
            **{f"{p}_max_us": max(g) for p, g in zip(PHASES, gaps)}}


def variants(cs, torch):
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_rl_loss import fused_rl_loss_fwd_ref
    fns = build_variants(_build)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    stream = torch.cuda.current_stream().cuda_stream
    for N, V in VARIANT_SHAPES:
        x, t, old, ref, adv, *_ = cs._loss_inputs(torch, gen, N, V,
                                                  torch.bfloat16)
        want = fused_rl_loss_fwd_ref(x, t, old, ref, adv)
        sets = cs._copies(torch, (x, t, old, ref, adv))
        out = torch.empty((6, N), dtype=torch.float32, device="cuda")
        row = {"N": N, "V": V}
        for name, fn in fns.items():
            for nsplit in SPLITS:
                def call(x, t, o, r, a):
                    err = fn(x.data_ptr(), t.data_ptr(), o.data_ptr(),
                             r.data_ptr(), a.data_ptr(), out.data_ptr(), N,
                             V, nsplit, 0.2, 1, stream)
                    if err:
                        raise SystemExit(f"{name} nsplit {nsplit}: CUDA "
                                         f"error {err}")
                call(x, t, old, ref, adv)
                if not name.startswith("probe_"):
                    for o, r in zip(out, want):
                        cs._check(f"fused_rl_loss_fwd {name}/{nsplit}",
                                  "float32", (N, V), o, r)
                row[f"{name}/{nsplit}_us"] = 1e3 * cs._device_ms(
                    torch, call, sets, CALLS, "fwd_kernel")
        print("vocab_variant_times", json.dumps(row), flush=True)
        del x, t, old, ref, adv, sets, want
        torch.cuda.empty_cache()
    for N, V, splits in STAMP_SHAPES:
        x, t, old, ref, adv, *_ = cs._loss_inputs(torch, gen, N, V,
                                                  torch.bfloat16)
        out = torch.empty((6, N), dtype=torch.float32, device="cuda")
        fn = fns["stamps"]
        for nsplit in splits:
            def call():
                fn(x.data_ptr(), t.data_ptr(), old.data_ptr(),
                   ref.data_ptr(), adv.data_ptr(), out.data_ptr(), N, V,
                   nsplit, 0.2, 1, stream)
            print("vocab_stamps", json.dumps({
                "N": N, "V": V, "nsplit": nsplit,
                **stamps(torch, fn, call, N * nsplit)}), flush=True)
        del x, t, old, ref, adv
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--rows-only", action="store_true",
                    help="time the rows only, no variants")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("vocab_pass_variants.py: CUDA is not available")
    cs = smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    name = "this" if src == ROOT else src.name
    rows(cs, torch, name)
    if not args.rows_only:
        if src != ROOT:
            raise SystemExit("variants: build this checkout's sources only "
                             "(drop --src or add --rows-only)")
        variants(cs, torch)


if __name__ == "__main__":
    main()
