"""The two scan wrappers (``mamba_scan``, ``rglru_scan``) as the main path
calls them: a few rows of a short sequence. Their CPU route at the
trainers' 4 x 80 rows (narrow widths) against the Pallas kernels in
interpret mode; the wrappers' mirrors of the C entries' short/long rule
against the sources; and the trimmed CUDA path, with CPU tensors sent down
it and the C entries recorded instead of called: inputs that already fit
go to the entry uncopied, B and C keep their strides, the forced path and
the stream are passed, one call counts one launch; bad shapes, mixed
devices and grad mode raise before any launch."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import mamba_scan as jax_mamba_scan
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rglru_scan import rglru_scan

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
# the port's sequential sum against the Pallas kernel's associative one,
# over 80 steps: the bars of tests/test_torch_ssm.py and
# tests/test_torch_hybrid.py
MAMBA_TOL = 1e-5
RGLRU_TOL = 2e-4


def _mamba_inputs(B, S, D, N, seed):
    """The reference kernel test's distributions; B and C as strided views
    of one (B, S, 7 + 2N) projection output, as the model hands them
    over."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, S, D)
    dt = (0.1 * np.log1p(np.exp(f(B, S, D)))).astype(np.float32)
    a = -np.abs(f(D, N))
    dbc = torch.from_numpy(f(B, S, 7 + 2 * N))
    return (*map(torch.from_numpy, (x, dt, a)), dbc[..., 7:7 + N],
            dbc[..., 7 + N:])


def _rglru_inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.4, 0.999, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize("B,S", [(4, 80), (2, 79)])
def test_mamba_cpu_route_matches_pallas_at_the_trainers_rows(B, S):
    """S of 80 and 79 tile (one time block), so the reference runs its
    Pallas kernel, in interpret mode here."""
    ins = _mamba_inputs(B, S, 128, 16, seed=S)
    want = jax_mamba_scan(*(jnp.asarray(t.contiguous().numpy())
                            for t in ins))
    got = mamba_scan(*ins)
    assert got.dtype == torch.float32 and got.shape == (B, S, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MAMBA_TOL, rtol=MAMBA_TOL)


@pytest.mark.parametrize("B,S", [(4, 80), (2, 79)])
def test_rglru_cpu_route_matches_pallas_at_the_trainers_rows(B, S):
    a, b = _rglru_inputs(B, S, 128, seed=S)
    want = jax_rglru_scan(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    got = rglru_scan(a, b)
    assert got.dtype == torch.float32 and got.shape == (B, S, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=RGLRU_TOL, rtol=RGLRU_TOL)


def _constant(source, name):
    text = (CSRC / f"{source}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_rglru_path_mirror_picks_what_the_entry_picks():
    """``path_for`` mirrors ``rglru_scan_path``: short (1) up to the
    source's threshold, long (2) past it; the main path's S of 79 and 80
    take the short path."""
    text = (CSRC / "rglru_scan.cu").read_text()
    assert re.search(r'extern "C" int rglru_scan_path\(int S\) \{ return '
                     r'S <= RG_SHORT_MAX \? 1 : 2; \}', text)
    T = rglru_ops.SHORT_MAX
    assert _constant("rglru_scan", "RG_SHORT_MAX") == T
    assert [rglru_ops.path_for(S) for S in (1, 79, 80, T, T + 1)] == \
        [1, 1, 1, 1, 2]


def test_mamba_path_mirror_picks_what_the_entry_picks():
    """``path_for`` mirrors ``mamba_scan_path``, with the source's
    constants: on 132 SMs one teacher-forced row (B = 1, D = 8192: 128
    blocks) takes the short path up to the threshold, the trainers' 4 rows
    (512 blocks, more than two an SM) the long path at every S."""
    assert (_constant("mamba_scan", "MS_SHORT_MAX"),
            _constant("mamba_scan", "MS_SHORT_BLOCKS"),
            _constant("mamba_scan", "MS_THREADS")
            // _constant("mamba_scan", "MS_SPLIT")) == \
        (mamba_ops.SHORT_MAX, mamba_ops.SHORT_BLOCKS, mamba_ops.CHANNELS)
    T = mamba_ops.SHORT_MAX
    steps = (1, 79, 80, T, T + 1)
    assert [mamba_ops.path_for(1, S, 8192, 132) for S in steps] == \
        [1, 1, 1, 1, 2]
    assert [mamba_ops.path_for(4, S, 8192, 132) for S in steps] == \
        [2] * 5
    # the edge: two blocks an SM take the short path, one more does not
    assert mamba_ops.path_for(2, 80, 132 * 64, 132) == 1
    assert mamba_ops.path_for(2, 80, 132 * 64 + 1, 132) == 2


def _as_if_on_card(monkeypatch):
    """Send CPU tensors down the wrappers' CUDA path, the C entries
    recorded instead of called; ``kernel_inputs`` hands its tensors on as
    they are (its copies are ``_build``'s own, tested with it)."""
    calls = {}

    def entry(name):
        def record(*args):
            calls[name] = args
            return 0
        return record
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "kernel", entry)
    monkeypatch.setattr(_build, "kernel_inputs", lambda name, *ts: ts)
    monkeypatch.setattr(_build, "raw_stream", lambda index: 77)
    return calls


def test_mamba_wrapper_hands_its_inputs_on_as_they_are(monkeypatch):
    """fp32 x, dt, A and the strided B, C views reach the entry uncopied,
    with the views' batch and time strides; a bf16 x is converted and B
    with a strided last axis is made contiguous; ``path`` is passed (0 by
    default)."""
    calls = _as_if_on_card(monkeypatch)
    B, S, D, N = 2, 5, 8, 16
    x, dt, a, b, c = _mamba_inputs(B, S, D, N, seed=0)
    n = mamba_scan.launches
    with torch.no_grad():
        y = mamba_scan(x, dt, a, b, c)
        got = calls["mamba_scan"]
        assert len(got) == len(_build.SIGNATURES["mamba_scan"]["mamba_scan"])
        assert got[:5] == tuple(t.data_ptr() for t in (x, dt, a, b, c))
        assert got[6:] == (B, S, D, N, S * (7 + 2 * N), 7 + 2 * N,
                           S * (7 + 2 * N), 7 + 2 * N, 0, 77)
        assert y.shape == (B, S, D) and y.dtype == torch.float32
        assert got[5] == y.data_ptr()
        bt = torch.zeros((B, S, N, 2)).select(-1, 0)     # last stride 2
        mamba_scan(x.bfloat16(), dt, a, bt, c, path=2)
        got = calls["mamba_scan"]
        assert got[0] != x.data_ptr() and got[3] != bt.data_ptr()
        assert got[10:12] == (S * N, N) and got[-2:] == (2, 77)
    assert mamba_scan.launches == n + 2


def test_rglru_wrapper_hands_its_inputs_on_as_they_are(monkeypatch):
    """fp32 a and b reach the entry uncopied; a bf16 b is converted;
    ``path`` is passed (0 by default)."""
    calls = _as_if_on_card(monkeypatch)
    a, b = _rglru_inputs(3, 4, 40, seed=1)
    n = rglru_scan.launches
    with torch.no_grad():
        h = rglru_scan(a, b)
        got = calls["rglru_scan"]
        assert len(got) == len(_build.SIGNATURES["rglru_scan"]["rglru_scan"])
        assert got[:3] == (a.data_ptr(), b.data_ptr(), h.data_ptr())
        assert got[3:] == (3, 4, 40, 0, 77)
        assert h.shape == a.shape and h.dtype == torch.float32
        rglru_scan(a, b.bfloat16(), path=1)
        got = calls["rglru_scan"]
        assert got[0] == a.data_ptr() and got[1] != b.data_ptr()
        assert got[-2:] == (1, 77)
    assert rglru_scan.launches == n + 2


def test_wrappers_raise_before_any_launch(monkeypatch):
    """On the CUDA path: inputs off one CUDA device (CPU tensors here, or
    B beside x on another device), unsupported shapes and inputs that
    require grad under grad mode raise, and nothing is launched."""
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "kernel", lambda name: pytest.fail(name))
    x, dt, a, b, c = _mamba_inputs(1, 4, 8, 8, seed=2)
    ra, rb = _rglru_inputs(1, 4, 8, seed=2)
    n = (mamba_scan.launches, rglru_scan.launches)
    with torch.no_grad():
        with pytest.raises(ValueError, match="one CUDA device"):
            mamba_scan(x, dt, a, b, c)
        with pytest.raises(ValueError, match="one CUDA device"):
            rglru_scan(ra, rb)
        with pytest.raises(ValueError, match="one CUDA device"):
            mamba_ops._rows(b, 0)
        with pytest.raises(ValueError, match="N in"):
            mamba_scan(x, dt, a[:, :5], b[..., :5], c[..., :5])
        with pytest.raises(ValueError, match="unsupported shapes"):
            mamba_scan(x, dt, a, b[:, :3], c)
        with pytest.raises(ValueError, match="unsupported shapes"):
            rglru_scan(ra, rb[..., :3])
    x.requires_grad_()
    rb.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        mamba_scan(x, dt, a, b, c)
    with pytest.raises(RuntimeError, match="no backward"):
        rglru_scan(ra, rb)
    assert (mamba_scan.launches, rglru_scan.launches) == n
