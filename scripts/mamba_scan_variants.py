#!/usr/bin/env python3
"""Time the port's two scan kernels, ``mamba_scan`` and ``rglru_scan``, on
the card.

    python3 scripts/mamba_scan_variants.py [--src DIR] [--rows-only]
                                           [--variants NAME,...]

Two parts, each printing JSON lines after the card's name and power limit:

- ``rows``: both scans of the tree at ``DIR`` (default: this checkout;
  another checkout of the repository, e.g. its parent commit unpacked by
  ``git archive`` under ``build/``, for an A/B on one card) at the
  trainers' reference-inference rows (4 x 80), one teacher-forced forward
  (1 x 80), the long prefill (1 x 2048), the ragged rows of chip_smoke.py
  phases 11 and 17, and the short path's threshold and one step past it.
  Each row holds the kernel against its plain version, then gives its time
  through the wrapper and through its C entry alone (CUDA events over
  back-to-back calls, inputs cycled past L2), its kernel's device time
  (``torch.profiler``), the bound and the path the entry took (``long``
  for a tree whose entry has one path).
- ``variants`` (this checkout only, skipped by ``--rows-only``): each
  scan's source built with its choices changed by text substitution,
  checked against the plain version and timed by device time with the
  path forced (``short``, ``long``), at B x 80 for B = 1 to 4, 4 x 88,
  4 x 96, B x 128 for B = 1, 2, 4 and the long prefill (for
  ``rglru_scan``: 4 x 80, 1 x 80, 4 x S for S = 96, 112, 128 and the long
  prefill), and by CUDA events over
  back-to-back launches (the device's time where it exceeds the host's);
  with ptxas's registers and spills per variant. For ``mamba_scan``:
  a share of each thread's states (0, 1/8, 1/4, 1/2) whose exp2 runs as
  a polynomial on the FMA pipes instead of the special-function units,
  the short path's stages (2, 3, 4, 5 doubling in length, or 4 of equal
  length) and unroll depth (2, 4, 8), the long path's chunk (16, 32, 64
  steps), its
  steps software-pipelined (``short_pipelined``: step r+1's loads and
  exps issued before step r's update, in two register sets) or in one
  loop across stage ends (``short_flat``), one or
  four lanes a channel instead of two, and four probes, wrong on purpose
  and timed only: ``probe_no_exp`` (the exps left out), ``probe_no_bc``
  (B and C not read), ``probe_no_shfl`` (y_t not summed over a channel's
  lanes), ``probe_no_store`` (y not written), ``probe_no_copy`` (the
  short path's copies left out) and ``probe_floor`` (no state math). For
  ``rglru_scan``:
  warps a block on the short path (1, 2, 4) and its stages (1, 2, 4, 8).
  ``--variants`` builds and times only the named ones beside the shipped
  source, and skips the rows.

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
MAMBA_ROWS = ((4, 80, 8192, 16), (1, 80, 8192, 16), (1, 2048, 8192, 16),
              (2, 79, 8192, 16), (3, 130, 96, 8), (4, 128, 8192, 16),
              (4, 129, 8192, 16))
RGLRU_ROWS = ((4, 80, 4096), (1, 80, 4096), (1, 2048, 4096), (3, 77, 1000),
              (2, 33, 4099), (4, 128, 4096), (4, 129, 4096))
PATHS = {"short": 1, "long": 2}
CALLS = 20
# name: substitutions in the source; a name starting "probe_" computes
# wrong values on purpose and is timed, not checked. "shipped" is the
# source as it stands.
EXP_LINE = "const float e = ex2(dtt * a2[j]);"
STATES_LOADER = "// B_t's or C_t's NH values"
POLY_COEFFS = (1.0000001, 0.69314694, 0.2402212, 0.05550713, 0.00967554,
               0.00132764)         # 2^f on [-1/2, 1/2], lowest power first
EXP2_POLY = """// 2^x on the FMA pipes: x = n + f with n = rint(x) (a magic-number add),
// 2^f for f in [-1/2, 1/2] by a degree-5 polynomial, and n added to the
// exponent bits; x is clamped at -126 (below, 2^-126)
__device__ __forceinline__ float exp2_poly(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;             // 1.5 * 2^23: rint(x) in bits
  const float f = x - (t - 12582912.f);
  float p = 0.00132764f;
  p = fmaf(p, f, 0.00967554f);
  p = fmaf(p, f, 0.05550713f);
  p = fmaf(p, f, 0.2402212f);
  p = fmaf(p, f, 0.69314694f);
  p = fmaf(p, f, 1.0000001f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

"""


def poly_share(k):
    """Substitutions that take the exp2 of the first k of a thread's states
    as EXP2_POLY."""
    return {STATES_LOADER: EXP2_POLY + STATES_LOADER,
            EXP_LINE: f"const float e = j < {k} ? exp2_poly(dtt * a2[j]) : "
                      "ex2(dtt * a2[j]);"}


def poly_error(torch):
    """EXP2_POLY's largest relative error against 2^x in float64, with its
    steps rounded to float32 as the card rounds them (each fmaf once),
    over x in [-126, 0] and over [-43.3, 0] (dt A in [-30, 0])."""
    out = {}
    for lo in (-126.0, -30.0 / 0.6931471805599453):
        x = torch.linspace(lo, 0.0, 2_000_001, dtype=torch.float64).float()
        t = x + 12582912.0
        f = (x - (t - 12582912.0)).double()
        p = torch.full_like(f, POLY_COEFFS[-1]).float()
        for c in POLY_COEFFS[-2::-1]:
            p = (p.double() * f + torch.tensor(c).float().double()).float()
        got = torch.ldexp(p.double(), (t.double() - 12582912.0))
        want = torch.exp2(x.double())
        out[f"max_rel_err_from_{lo:.1f}"] = ((got - want).abs()
                                             / want).max().item()
    return out
SHORT_UNROLL = ("#pragma unroll 4\n    for (int r = k ? stage_end(k - 1, S) : 0; "
                "r < t1; ++r) {")
STAGE_END = "  return k == MS_STAGES - 1 ? S : S >> (MS_STAGES - 1 - k);"
# the short path's steps, and the same software-pipelined: step r+1's
# loads and exps issued before step r's update, in two register sets
SHORT_STEPS = (
    "  float* yp = y + row0 * D + d;               // y_0 of the channel\n",
    "      if (store) yp[static_cast<size_t>(r) * D] = acc;\n    }\n  }\n}\n")
# the short path's steps as one loop, unrolled across stage ends, a stage
# waited for where its first step comes up
FLAT = """  float* yp = y + row0 * D + d;
  int landed = 0, stage = 0;                  // steps landed so far
#pragma unroll 4
  for (int r = 0; r < S; ++r) {
    while (r >= landed) {
      hopper::mbar_wait(hopper::smem_addr(&full[stage]), 0);
      landed = stage_end(stage++, S);
    }
    const float acc = step<NH>(h, a2, s_dt[r * MS_CHANNELS + ch],
                               s_x[r * MS_CHANNELS + ch],
                               s_b + r * N + part * NH,
                               s_c + r * N + part * NH);
    if (store) yp[static_cast<size_t>(r) * D] = acc;
  }
}
"""
PIPELINED = """  float* yp = y + row0 * D + d;
  float e0[NH], b0[NH], c0[NH], e1[NH], b1[NH], c1[NH], dx0, dx1;
  int landed = 0, stage = 0;                  // steps landed so far
  auto fetch = [&](int r, float (&e)[NH], float (&bv)[NH], float (&cv)[NH],
                   float& dx) {
    while (r >= landed) {
      hopper::mbar_wait(hopper::smem_addr(&full[stage]), 0);
      landed = stage_end(stage++, S);
    }
    const float dtt = s_dt[r * MS_CHANNELS + ch];
    dx = dtt * s_x[r * MS_CHANNELS + ch];
    load_states<NH>(bv, s_b + r * N + part * NH);
    load_states<NH>(cv, s_c + r * N + part * NH);
#pragma unroll
    for (int j = 0; j < NH; ++j) e[j] = ex2(dtt * a2[j]);
  };
  auto update = [&](int r, const float (&e)[NH], const float (&bv)[NH],
                    const float (&cv)[NH], float dx) {
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      h[j] = e[j] * h[j] + dx * bv[j];
      if (j % 2) acc1 += h[j] * cv[j];
      else acc0 += h[j] * cv[j];
    }
    float acc = acc0 + acc1;
#pragma unroll
    for (int o = 1; o < MS_SPLIT; o <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (store) yp[static_cast<size_t>(r) * D] = acc;
  };
  fetch(0, e0, b0, c0, dx0);
  for (int r = 0; r < S; r += 2) {
    if (r + 1 < S) fetch(r + 1, e1, b1, c1, dx1);
    update(r, e0, b0, c0, dx0);
    if (r + 1 >= S) break;
    if (r + 2 < S) fetch(r + 2, e0, b0, c0, dx0);
    update(r + 1, e1, b1, c1, dx1);
  }
}
"""
MAMBA_VARIANTS = {
    "shipped": {},
    **{f"poly_{k}_of_8": poly_share(k) for k in (1, 2, 4)},
    **{f"stages{k}": {"constexpr int MS_STAGES = 3;":
                      f"constexpr int MS_STAGES = {k};"} for k in (2, 4, 5)},
    # the long path's chunks of 16 or 64 steps instead of 32
    **{f"tchunk{k}": {"constexpr int MS_TCHUNK = 32;":
                      f"constexpr int MS_TCHUNK = {k};"} for k in (16, 64)},
    # four stages of equal length instead of doubling ones
    "stages4_even": {"constexpr int MS_STAGES = 3;":
                     "constexpr int MS_STAGES = 4;",
                     STAGE_END: "  return min(S, (k + 1) * ((S + 3) / 4));"},
    # one lane a channel (N states a thread, no shuffle, 128 channels a
    # block) instead of two
    "lanes1": {"constexpr int MS_SPLIT = 2;": "constexpr int MS_SPLIT = 1;"},
    # four lanes a channel (N/4 states a thread) in blocks of 256 threads,
    # still 64 channels a block: twice the warps
    "lanes4": {"constexpr int MS_SPLIT = 2;": "constexpr int MS_SPLIT = 4;",
               "constexpr int MS_THREADS = 128;":
               "constexpr int MS_THREADS = 256;"},
    "short_pipelined": {SHORT_STEPS: PIPELINED},
    "short_flat": {SHORT_STEPS: FLAT},
    # the short path's steps unrolled 2 or 8 deep instead of 4
    **{f"short_unroll{k}": {SHORT_UNROLL: SHORT_UNROLL.replace(
        "unroll 4", f"unroll {k}")} for k in (2, 8)},
    "probe_no_exp": {EXP_LINE: "const float e = dtt * a2[j];"},
    # y_t not summed over the channel's lanes, or not stored
    "probe_no_shfl": {"    acc += __shfl_xor_sync(0xffffffffu, acc, o);":
                      "    acc += 1.f;"},
    "probe_no_store": {"if (store) yp[": "if (acc == 1234.5f) yp["},
    # the short path's copies left out (the steps read whatever shared
    # memory holds): its step loop alone
    "probe_no_copy": {"        hopper::cp_async16(sx, gx, cbytes);\n"
                      "        hopper::cp_async16(sdt, gdt, cbytes);\n": "",
                      "        hopper::cp_async4(sx, gx, cbytes);\n"
                      "        hopper::cp_async4(sdt, gdt, cbytes);\n": "",
                      "      hopper::cp_async4(hopper::smem_addr(s_b + e), "
                      "Bb + te * sb_t + n, 4);\n": "",
                      "      hopper::cp_async4(hopper::smem_addr(s_c + e), "
                      "Cb + te * sc_t + n, 4);\n": ""},
    # no state math: each step returns dt_t x_t (the data movement, the
    # loop and the stores alone)
    "probe_floor": {("  float bv[NH], cv[NH];\n  load_states<NH>(bv, b);",
                     "  return acc;\n}\n"): "  return dtt * xt;\n}\n"},
    # B_t and C_t not read from shared memory (ones instead)
    "probe_no_bc": {"const float4 w = reinterpret_cast<const float4*>(p)[q];":
                    "const float4 w = make_float4(1.f, 1.f, 1.f, 1.f);"}}
RGLRU_VARIANTS = {
    "shipped": {},
    **{f"warps{k}": {"constexpr int RG_SHORT_WARPS = 1;":
                     f"constexpr int RG_SHORT_WARPS = {k};"} for k in (2, 4)},
    **{f"stages{k}": {"constexpr int RG_STAGES = 4;":
                      f"constexpr int RG_STAGES = {k};"} for k in (1, 2, 8)}}
MAMBA_VARIANT_SHAPES = ((4, 80, 8192, 16), (1, 80, 8192, 16),
                        (2, 80, 8192, 16), (3, 80, 8192, 16),
                        (4, 88, 8192, 16), (4, 96, 8192, 16),
                        (1, 128, 8192, 16), (2, 128, 8192, 16),
                        (4, 128, 8192, 16), (1, 2048, 8192, 16))
RGLRU_VARIANT_SHAPES = ((4, 80, 4096), (1, 80, 4096), (4, 96, 4096),
                        (4, 112, 4096), (4, 128, 4096), (1, 2048, 4096))


def smoke():
    """chip_smoke.py's helpers (inputs, L2-cycled copies, event and
    profiler timers, bounds)."""
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    return chip_smoke


def sm_clock_hz():
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def with_path(_build, source, entry):
    """True where the tree's entry takes a path (0: the entry's choice)."""
    return len(_build.SIGNATURES[source][entry]) in (8, 16)


def mamba_entry(_build, torch, fn, B, S, D, N, path=0, out=None):
    """A call of ``fn`` (a ``mamba_scan`` C entry) on the wrapper's inputs,
    into ``out`` (or a tensor of its own)."""
    y = torch.empty((B, S, D), device="cuda") if out is None else out
    stream = torch.cuda.current_stream().cuda_stream
    tail = (path, stream) if with_path(_build, "mamba_scan",
                                       "mamba_scan") else (stream,)
    return lambda x, dt, a, b, c: fn(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), B, S, D, N, b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), *tail)


def rglru_entry(_build, torch, fn, B, S, W, path=0, out=None):
    """A call of ``fn`` (an ``rglru_scan`` C entry), as ``mamba_entry``."""
    h = torch.empty((B, S, W), device="cuda") if out is None else out
    stream = torch.cuda.current_stream().cuda_stream
    tail = (path, stream) if with_path(_build, "rglru_scan",
                                       "rglru_scan") else (stream,)
    return lambda a, b: fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W,
                           *tail)


def path_of(_build, name, *shape):
    """The path the entry takes at ``shape`` (``long`` where it has one)."""
    if f"{name}_path" not in _build.SIGNATURES[name]:
        return "long"
    took = _build.kernel(f"{name}_path")(*shape)
    return {v: k for k, v in PATHS.items()}[took]


def rows(cs, torch, tree):
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_ref
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
    _build.build_all()
    sfu_per_s = cs.SFU_PER_SM_CLOCK * cs.SMS * sm_clock_hz()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(2024)
    for B, S, D, N in MAMBA_ROWS:
        ins = cs._mamba_inputs(torch, gen, B, S, D, N)
        entry = mamba_entry(_build, torch, _build.kernel("mamba_scan"), B, S,
                            D, N)
        _build.check("mamba_scan", entry(*ins))
        err = cs._check("mamba_scan", "float32", (B, S, D, N),
                        mamba_scan(*ins), mamba_scan_ref(*ins))
        sets = cs._copies(torch, ins)
        print("scan_row", json.dumps(dict(
            tree=tree, kernel="mamba_scan", B=B, S=S, D=D, N=N,
            path=path_of(_build, "mamba_scan", B, S, D, n_sm),
            max_abs_err=err,
            **cs._scan_times(torch, mamba_scan, entry, sets, "mamba_scan",
                             cs._scan_iters(B, S)),
            **cs._mamba_bound(B, S, D, N, sfu_per_s))), flush=True)
        del ins, sets, entry
    for B, S, W in RGLRU_ROWS:
        ins = cs._rglru_inputs(torch, gen, B, S, W)
        entry = rglru_entry(_build, torch, _build.kernel("rglru_scan"), B, S,
                            W)
        _build.check("rglru_scan", entry(*ins))
        err = cs._check("rglru_scan", "float32", (B, S, W), rglru_scan(*ins),
                        rglru_scan_ref(*ins))
        sets = cs._copies(torch, ins)
        print("scan_row", json.dumps(dict(
            tree=tree, kernel="rglru_scan", B=B, S=S, W=W,
            path=path_of(_build, "rglru_scan", S), max_abs_err=err,
            **cs._scan_times(torch, rglru_scan, entry, sets, "rglru_scan",
                             cs._scan_iters(B, S)),
            **cs._rglru_bound(B, S, W))), flush=True)
        del ins, sets, entry
    torch.cuda.empty_cache()


def build_variants(_build, source, variants):
    """Each variant's copy of ``source``.cu under build/variants/<source>/
    <name>/, built in parallel; returns {name: its C entry}, and prints
    ptxas's registers and spills of each kernel."""
    procs = {}
    for name, subs in variants.items():
        out = ROOT / "build" / "variants" / source / name
        out.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            (out / f.name).write_text(f.read_text())
        text = (_build.CSRC / f"{source}.cu").read_text()
        for old, new in subs.items():
            if isinstance(old, tuple):      # the span from old[0] to old[1]
                i = text.find(old[0])
                j = text.find(old[1], i)
                if i < 0 or j < 0:
                    raise SystemExit(f"{source} {name}: span {old[0]!r} not "
                                     "in the source")
                text = text[:i] + new + text[j + len(old[1]):]
            elif old not in text:
                raise SystemExit(f"{source} {name}: {old!r} not in the source")
            else:
                text = text.replace(old, new)
        (out / f"{source}.cu").write_text(text)
        lib = out / f"{source}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(out / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {source} {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), source)
        fn.argtypes = _build.SIGNATURES[source][source]
        fn.restype = ctypes.c_int
        fns[name] = fn
        lines = log.splitlines()
        regs = {}
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                text = " ".join(lines[i + 1:i + 4])
                kernel = re.search(r"(\w+_kernel)", m.group(1)).group(1)
                n = re.search(r"ILi(\d+)E", m.group(1))
                regs[kernel + (f"<{n.group(1)}>" if n else "")] = {
                    "registers": int(re.search(r"Used (\d+) registers",
                                               text).group(1)),
                    "spill_stores": int(re.search(
                        r"(\d+) bytes spill stores", text).group(1))}
        print("scan_variant", json.dumps({"kernel": source, "variant": name,
                                          **regs}), flush=True)
    return fns


def variant_times(cs, torch, _build, source, variants, shapes, inputs, plain,
                  entry):
    """Device µs of each variant at each shape and forced path, each held
    to the plain version first (but probes)."""
    fns = build_variants(_build, source, variants)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for shape in shapes:
        ins = inputs(torch, gen, *shape)
        want = plain(*ins)
        sets = cs._copies(torch, ins)
        row = {"kernel": source, "shape": shape}
        for name, fn in fns.items():
            for pname, path in PATHS.items():
                if path == 1 and shape[1] > 128:
                    continue
                out = torch.full_like(want, float("nan"))
                call = entry(_build, torch, fn, *shape, path=path, out=out)
                _build.check(f"{source} {name}", call(*ins))
                if not name.startswith("probe_"):
                    cs._check(f"{source} {name}/{pname}", "float32", shape,
                              out, want)
                try:
                    row[f"{name}/{pname}_us"] = 1e3 * cs._device_ms(
                        torch, call, sets, CALLS, source)
                except AssertionError:          # the profiler saw none
                    row[f"{name}/{pname}_us"] = None
                # back-to-back launches by CUDA events: the device's time
                # where it exceeds the host's (mamba_scan), else the host's
                row[f"{name}/{pname}_events_us"] = 1e3 * cs._time_ms(
                    torch, call, sets, 50)
        print("scan_variant_times", json.dumps(row), flush=True)
        del ins, want, sets
        torch.cuda.empty_cache()


def variants(cs, torch, only):
    from repro_torch.kernels import _build
    from repro_torch.kernels.mamba_scan import mamba_scan_ref
    from repro_torch.kernels.rglru_scan import rglru_scan_ref
    print("exp2_poly", json.dumps(poly_error(torch)), flush=True)
    for source, table, shapes, inputs, plain, entry in (
            ("mamba_scan", MAMBA_VARIANTS, MAMBA_VARIANT_SHAPES,
             cs._mamba_inputs, mamba_scan_ref, mamba_entry),
            ("rglru_scan", RGLRU_VARIANTS, RGLRU_VARIANT_SHAPES,
             cs._rglru_inputs, rglru_scan_ref, rglru_entry)):
        picked = {k: v for k, v in table.items()
                  if only is None or k == "shipped" or k in only}
        if len(picked) > 1 or only is None:
            variant_times(cs, torch, _build, source, picked, shapes, inputs,
                          plain, entry)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--rows-only", action="store_true",
                    help="time the rows only, no variants")
    ap.add_argument("--variants", default=None,
                    help="comma-separated variant names (beside shipped)")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mamba_scan_variants.py: CUDA is not available")
    cs = smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.variants is None:
        rows(cs, torch, "this" if src == ROOT else src.name)
    if not args.rows_only:
        if src != ROOT:
            raise SystemExit("variants: build this checkout's sources only "
                             "(drop --src or add --rows-only)")
        variants(cs, torch, None if args.variants is None
                 else set(args.variants.split(",")))


if __name__ == "__main__":
    main()
