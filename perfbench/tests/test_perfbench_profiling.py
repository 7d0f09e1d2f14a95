"""The profiler arithmetic on a made-up trace: busy time is the union of
the device's intervals, the SMs' busy time that of the kernels alone,
the SMs' idle gaps go to the host spans open in them, and the metric
readers read what they should."""
import pytest

from perfbench.core.profiling import Trace, short_name
from perfbench.core.spec import load_module

MS = 1_000_000


def _trace():
    ops = [("void fwd_kernel<bf16>(x)", 0 * MS, 2 * MS),
           ("void bwd_kernel<bf16>(x)", 1 * MS, 3 * MS),     # overlaps
           ("void flash_fwd_kernel(x)", 6 * MS, 1 * MS),
           ("Memcpy DtoH ", 8 * MS, 1 * MS)]
    spans = [("generate", 3 * MS, 7 * MS), ("update", 5 * MS, 10 * MS)]
    return Trace(ops, 0, 10 * MS, spans)


def test_busy_is_the_union_of_intervals():
    tr = _trace()
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.006)       # [0,4], [6,7], [8,9]
    assert tr.kernel_busy_s == pytest.approx(0.005)  # not the copy
    names = dict(tr.device_ops())
    assert names["bwd_kernel<bf16>"] == pytest.approx(0.003)


def test_idle_gaps_by_open_spans():
    gaps = dict(_trace().idle_gaps())
    # no kernel in [4,6] and [7,10] (the copy in [8,9] leaves the SMs
    # idle); generate is open in [3,7], update in [5,10]
    assert gaps["generate"] == pytest.approx(0.001)
    assert gaps["generate+update"] == pytest.approx(0.001)
    assert gaps["update"] == pytest.approx(0.003)


def test_kernel_patterns_leave_flash_out():
    tr = _trace()
    assert tr.kernels(r"\bfwd_kernel\b", exclude="flash") == \
        [pytest.approx(0.002)]


def test_readers_of_the_trace():
    tr = _trace()
    idle = load_module("metrics", "device_idle.train").read({"trace": tr})
    assert idle == pytest.approx(50.0)
    roof = load_module("metrics", "fused_rl_loss_roofline").read(
        {"trace": tr, "loss_shape": (1000, 1000, 2)})
    least = (2e6 + 20e3 + 24e3 + 4e6 + 24e3) / 3.35e12
    assert roof == pytest.approx(100 * least / 0.005)
    assert load_module("metrics", "device_idle.train").read(
        {"trace": None}) is None


def test_short_names():
    assert short_name("void a::(anonymous namespace)::k<int>(int)") == \
        "a::k<int>"
