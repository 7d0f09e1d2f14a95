"""DeepSeek-V2's cell on the CPU at a small size: the rollout driver end to
end through the engine's latent pool and held experts, the four readers
of its counters and spans (each against a hand count, and None on a
program without what it reads), and ``flops_mla_moe.py``'s FLOPs
against a count made by hand."""
import sys
import time

import pytest

from perfbench.core import compare
from perfbench.core import flops_mla_moe as fm
from perfbench.core.profiling import Trace
from perfbench.core.spec import load_module
from perfbench.tests import tiny
from perfbench.tests.conftest import TINY_MOE
from repro_torch.core.obs import tracing

MS = 1_000_000
READERS = ("mfu.deepseek_v2", "expert_rows_per_pick.deepseek_v2",
           "latent_gather_mb_per_token.deepseek_v2",
           "moe_idle_ms.deepseek_v2")
SECONDS = 2.0


def _read(name, ctx):
    return load_module("metrics", name).read(ctx)


# the small size's limits: above what sound runs read here over 8 seeds
# (logprob gaps 1.0e-3 to 2.0e-3, picks changed in 0 to 2.6% of the
# (position, layer) pairs), under what an altered token reads (0.15 or
# more) and a routing fault (most picks changed); the fp8 control reads
# 0.011 to 0.024 and 1.9 to 7.2%: the sample holds ~100 positions and
# 2 MoE layers, too few for the share to part sound from fp8 here
LIMITS = {"logprob_gap": 0.02, "pick_gap": 0.05}
SEED = 2**31 + 11


def _run_tiny(seed=SEED):
    cell = tiny.cell("deepseek_v2_ep8", "rollout_groups_512", LIMITS)
    driver = load_module("drivers", cell.traffic["entry"])
    res = driver.run(cell, seed=seed, seconds=SECONDS, trace=False,
                     device="cpu", t_process=time.monotonic())
    return cell, driver, res


def test_rollout_driver_runs_deepseek_v2_end_to_end():
    """The tiny cell's sound run, its comparison routed as the engine
    routed: correct, its end-to-end metrics and three of its readers (the
    fourth needs a trace); every sampled request's picks cover each
    position the trunk ran; the fp8 control reads three times the
    program's logprob gap and no fewer changed picks (the small sample
    may hold none), an altered token above the logprob limit."""
    cell, driver, res = _run_tiny()
    assert compare.judge(res["checks"]), res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["e2e"]["gen_tokens_per_s"] > 0
    for tokens, P, lps, picks in res["followed"]["sample"]:
        assert picks.shape == (len(tokens) - 1, 2, 4) and picks.max() <= 4
    ctx = res["ctx"]
    assert 0 < _read("mfu.deepseek_v2", ctx) < 100
    assert _read("expert_rows_per_pick.deepseek_v2", ctx) >= 1
    assert _read("latent_gather_mb_per_token.deepseek_v2", ctx) > 0
    assert _read("moe_idle_ms.deepseek_v2", ctx) is None
    got = driver.readings(cell, res, SEED, "cpu")
    assert got["control"]["logprob_gap"] > 3 * got["program"]["logprob_gap"]
    assert got["control"]["pick_gap"] >= got["program"]["pick_gap"], got
    assert got["token_altered"]["logprob_gap"] > LIMITS["logprob_gap"]


def test_routed_comparison_catches_a_routing_fault(monkeypatch):
    """The engine's gate made to keep the wrong groups (top groups by
    their smallest score): the served logprobs, routed as the engine
    routed, may still agree, but the reference's own gate changes the
    picks of many (position, layer) pairs, and the run is not correct."""
    from repro_torch.models import moe as tmoe
    route = tmoe.route

    def wrong(probs, cfg):
        return route(-probs + probs.max(), cfg)[:2] + (probs,)
    monkeypatch.setattr(tmoe, "route", wrong)
    _, _, res = _run_tiny()
    assert res["checks"]["pick_gap"]["value"] > LIMITS["pick_gap"]
    assert not compare.judge(res["checks"])


def _delta(**series):
    out = {}
    for key, v in series.items():
        name, _, label = key.partition("__")
        labels = tuple(sorted(tuple(kv.split("=")) for kv in label.split(",")
                              if kv))
        out[(name, labels)] = {"value": v}
    return out


class _Cell:
    config = {"port": dict(
        TINY_MOE, arch_type="moe", first_dense_layers=1, vocab_size=512)}


def test_counter_readers_by_hand():
    c = _Cell.config["port"]
    d = _delta(**{
        "rollout_model_tokens_total__engine=cb,phase=prefill": 30.0,
        "rollout_model_tokens_total__engine=cb,phase=decode": 10.0,
        "rollout_attended_pairs_total__engine=cb,phase=prefill": 200.0,
        "rollout_attended_pairs_total__engine=cb,phase=decode": 90.0,
        "moe_held_picks_total__engine=cb,phase=prefill": 40.0,
        "moe_held_picks_total__engine=cb,phase=decode": 8.0,
        "moe_expert_rows_total__engine=cb,phase=prefill": 50.0,
        "moe_expert_rows_total__engine=cb,phase=decode": 10.0,
        "rollout_tokens_total__engine=cb": 12.0,
        "rollout_kv_gather_bytes_total__engine=cb,kind=latent": 6e6})
    ctx = {"delta": d, "window_s": 2.0, "cell": _Cell, "trace": None}
    assert _read("expert_rows_per_pick.deepseek_v2", ctx) == \
        pytest.approx(60 / 48)
    assert _read("latent_gather_mb_per_token.deepseek_v2", ctx) == \
        pytest.approx(0.5)
    want = (40 * fm.token_flops(c) + 200 * fm.pair_flops(c, "prefill")
            + 90 * fm.pair_flops(c, "decode") + 48 * fm.pick_flops(c)
            + 12 * fm.unembed_flops(c))
    assert _read("mfu.deepseek_v2", ctx) == \
        pytest.approx(100 * want / (2.0 * 989e12))


def test_readers_read_none_on_a_program_without_them(monkeypatch):
    """The parent's program: no counters by phase, no held picks, no
    latent gather (only the GQA series), no ``moe.ffn`` spans."""
    old = {"delta": _delta(**{
        "rollout_tokens_total__engine=cb": 600.0,
        "rollout_kv_gather_bytes_total__engine=cb": 5e9}),
        "window_s": 2.0, "cell": _Cell, "trace": None}
    for name in READERS:
        assert _read(name, old) is None
    with tracing.scoped():                     # a trace, no program span
        assert _read("moe_idle_ms.deepseek_v2",
                     dict(old, trace=_trace())) is None
    with tracing.scoped() as log:              # a checkout with no tracer
        _spans(log)
        monkeypatch.setitem(sys.modules, "repro_torch.core.obs.tracing",
                            None)
        assert _read("moe_idle_ms.deepseek_v2",
                     dict(old, trace=_trace())) is None


def _trace():
    ops = [("void gemm(x)", 12 * MS, 8 * MS),             # [12, 20]
           ("void grouped(x)", 22 * MS, 2 * MS)]           # [22, 24]
    return Trace(ops, 0, 100 * MS, [])


def _spans(log):
    """Two whole rounds with two ``moe.ffn`` spans under their
    ``forward``, one round cut by the stretch's end, and a prefill's
    ``moe.ffn`` (not a round's)."""
    ids = iter(range(1, 1000))

    def add(kind, a, b, parent=0):
        sid = next(ids)
        log._add("rollout-0", kind, int(a * MS), int(b * MS), {},
                 (sid, parent, 1))
        return sid
    for start, moe in ((10, ((11, 14), (18, 26))), (50, ((52, 55),)),
                       (95, ((96, 99),))):
        r = add("cb.round", start, start + 30 if start < 95 else 105)
        fw = add("forward", start, start + 20, r)
        for a, b in moe:
            add("moe.ffn", a, b, fw)
    p = add("cb.prefill", 70, 80)
    add("moe.ffn", 71, 75, add("forward", 70, 78, p))


def test_moe_idle_by_hand():
    with tracing.scoped() as log:
        _spans(log)
        # round 1: [11, 14] idle 1 (gemm from 12), [18, 26] idle 4
        # ([20, 22] and [24, 26]); round 2: [52, 55] idle 3. The cut
        # round and the prefill are left out.
        assert _read("moe_idle_ms.deepseek_v2", {"trace": _trace()}) == \
            pytest.approx((1 + 4 + 3) / 2)


def test_flops_by_hand():
    """The tiny block: d 64, 4 heads, r 32, dr 16, dn 16, dv 16, q_lora
    48, 16 experts, 1 shared of 32, a dense MLP of 96, 3 layers (1
    dense), vocabulary 512."""
    c = _Cell.config["port"]
    proj = 64 * 48 + 48 * 4 * 32 + 64 * 48 + 32 * 4 * 32 + 4 * 16 * 64
    assert fm.attn_proj_flops(c) == 2 * proj
    assert fm.token_flops(c) == 3 * 2 * proj + 6 * 64 * 96 \
        + 2 * (6 * 64 * 32 + 2 * 64 * 16)
    assert fm.pick_flops(c) == 6 * 64 * 32
    assert fm.pair_flops(c, "decode") == 3 * (2 * 4 * 48 + 2 * 4 * 32)
    assert fm.pair_flops(c, "prefill") == 3 * (2 * 4 * 32 + 2 * 4 * 16)
    assert fm.unembed_flops(c) == 2 * 64 * 512
    assert fm.model_flops(c, {}) is None
