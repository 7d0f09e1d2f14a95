"""On the card: the program's spans and the profiler's device events share
one clock. A span around a bf16 matmul and the synchronisation after it
holds the matmul kernel's interval, and a continuous-engine decode round
(``cb.round``, which ends in the ``.tolist()`` of its tokens) holds its
``decode_kernel``. Skips where there is no card (the fixture decides,
never the import)."""
import pytest
import torch

from perfbench.core.profiling import COPY_OPS, Profiled


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return "cuda"


def _inside(kernels, spans):
    """Every kernel interval lies inside some span."""
    return all(any(sp.start_ns <= s and e <= sp.end_ns for sp in spans)
               for s, e in kernels)


def test_a_span_holds_its_matmul_kernel(card):
    from repro_torch.core.obs import tracing
    a = torch.randn(4096, 4096, device=card, dtype=torch.bfloat16)
    torch.mm(a, a)
    torch.cuda.synchronize()
    with tracing.scoped(on=False) as log:       # the profiler turns it on
        prof = Profiled()
        prof.start()
        with tracing.span("mm"):
            torch.mm(a, a)
            torch.cuda.synchronize()
        prof.stop()
    tr = prof.trace([])
    kernels = [(s, e) for n, s, e in tr.ops if not COPY_OPS.match(n)]
    spans = [e for e in log.events() if e.kind == "mm"]
    assert kernels and len(spans) == 1
    assert _inside(kernels, spans)


def test_a_decode_round_holds_its_decode_kernel(card):
    import re

    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.obs import tracing
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.models import init_params
    cfg = ModelConfig(name="tiny", arch_type="dense", citation="",
                      num_layers=2, d_model=256, num_heads=4,
                      num_kv_heads=2, head_dim=64, d_ff=512,
                      vocab_size=512)
    params = init_params(0, cfg, device=card)
    eng = ContinuousBatchingEngine(cfg, num_slots=4, page_size=8,
                                   max_len=64, device=card)

    def call():
        seqs = [eng.make_sequence(list(range(1, n + 1)), max_new=3)
                for n in (5, 9, 17)]
        eng.generate(params, seqs)
    call()                                      # builds the kernels
    with tracing.scoped(on=False) as log:
        prof = Profiled()
        prof.start()
        call()
        prof.stop()
    tr = prof.trace([])
    rx = re.compile(r"\bdecode_kernel\b")
    kernels = [(s, e) for n, s, e in tr.ops if rx.search(n)]
    rounds = [e for e in log.events() if e.kind == "cb.round"]
    assert len(rounds) == 2 and kernels
    assert _inside(kernels, rounds)
