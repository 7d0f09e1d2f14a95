"""The port's serving path on the CPU: the continuous-batching engine's
behaviour logprobs against a teacher-forced reference forward, sampling
determinism, the engine invariants of ``tests/test_continuous_batching.py``
(slot reuse, no page leaks, EOS at a page boundary, parked pages), and
the ``serve`` entry point."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs.base import ModelConfig
from repro_torch.core.obs import MetricsRegistry
from repro_torch.engines.continuous_batching import (
    ContinuousBatchingEngine, KVPoolExhausted, PagedKVPool)
from repro_torch.models.convert import params_from_reference
from repro_torch.rl import generate


@functools.lru_cache(maxsize=None)
def _setup(compute_dtype="bfloat16"):
    ref_cfg = tiny_cfg(compute_dtype=compute_dtype)
    ref_params = jax_init_params(jax.random.PRNGKey(0), ref_cfg)
    cfg = ModelConfig(**dataclasses.asdict(ref_cfg))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref_cfg, ref_params, cfg, params


def _engine(cfg, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_len", 32)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("seed", 7)
    kw.setdefault("device", "cpu")
    return ContinuousBatchingEngine(cfg, **kw)


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(3, 259, n).tolist() for n in (3, 5, 4, 9, 6)]


def test_engine_logprobs_match_teacher_forced_reference():
    """Tokens sampled by the port's engine, scored by the reference's
    forward: the behaviour logprobs agree (fp32 compute and KV pool)."""
    ref_cfg, ref_params, cfg, params = _setup("float32")
    temp = 0.8
    eng = _engine(cfg, num_slots=3, max_new_tokens=7, temperature=temp,
                  eos_id=-1, dtype=torch.float32)
    seqs = [eng.make_sequence(p) for p in _prompts()]
    fin, _ = eng.generate(params, seqs)
    assert len(fin) == len(seqs)
    for q in fin:
        toks = np.asarray(q.tokens, np.int32)[None]
        logits, _ = jax_forward(ref_params, ref_cfg,
                                {"tokens": jnp.asarray(toks)})
        logp = jax.nn.log_softmax(
            np.asarray(logits, np.float32)[0] / temp, axis=-1)
        want = [float(logp[t - 1, toks[0, t]])
                for t in range(q.prompt_len, len(q.tokens))]
        np.testing.assert_allclose(q.logprobs[q.prompt_len:], want,
                                   atol=1e-4, rtol=1e-4)


def test_fixed_generate_logprobs_match_teacher_forced_reference():
    """The fixed backend keeps a bf16 KV cache, as the reference's does,
    so it is scored by the reference's decode steps over the same cache
    dtype, fed the port's tokens."""
    ref_cfg, ref_params, cfg, params = _setup("float32")
    prompts = [np.asarray(p, np.int32) for p in _prompts()[:3]]
    rows = generate(params, cfg, prompts, 11, max_new_tokens=5,
                    temperature=1.0, eos_id=-1, device="cpu")
    toks = np.stack([r["tokens"] for r in rows]).astype(np.int32)
    B, total = toks.shape                           # batch padded to 4
    step = jax.jit(functools.partial(jax_decode_step, cfg=ref_cfg,
                                     use_pallas=True))
    cache = jax_init_cache(ref_cfg, B, total)
    want = np.zeros((B, total), np.float32)
    for t in range(total - 1):
        logits, cache = step(ref_params, cache=cache,
                             token=jnp.asarray(toks[:, t]),
                             pos=jnp.full((B,), t, jnp.int32))
        logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32)))
        want[:, t + 1] = logp[np.arange(B), toks[:, t + 1]]
    for i, r in enumerate(rows):
        assert (r["tokens"][:r["prompt_len"]] == prompts[i]).all()
        np.testing.assert_allclose(r["logprobs"][r["prompt_len"]:],
                                   want[i, r["prompt_len"]:],
                                   atol=1e-4, rtol=1e-4)


def test_sampling_is_deterministic_and_independent_of_slots():
    _, _, cfg, params = _setup()

    def run(num_slots, reverse):
        eng = _engine(cfg, num_slots=num_slots, eos_id=-1)
        seqs = [eng.make_sequence(p) for p in _prompts()]
        order = seqs[::-1] if reverse else seqs     # uids fixed by creation
        eng.generate(params, order)
        return {q.uid: q.tokens for q in seqs}

    a = run(2, False)
    assert run(2, False) == a                        # same run, same tokens
    assert run(1, True) == a                         # other slots, batches
    assert run(4, True) == a


# ---------------------------------------------------------------------------
# engine invariants (mirrors tests/test_continuous_batching.py)
# ---------------------------------------------------------------------------

def test_kv_page_alloc_free_no_leak():
    _, _, cfg, _ = _setup()
    pool = PagedKVPool(cfg, num_pages=9, page_size=4, pages_per_seq=4,
                       device="cpu")
    total = pool.free_pages
    assert total == 8                              # page 0 reserved
    pool.ensure(0, 5)
    pool.ensure(1, 13)
    assert pool.pages_in_use == 6 and pool.free_pages == 2
    pool.ensure(0, 9)
    assert pool.pages_in_use == 7
    with pytest.raises(KVPoolExhausted):
        pool.ensure(2, 12)
    assert not pool.owns(2) and pool.free_pages == 1
    pool.release(0)
    pool.release(1)
    assert pool.pages_in_use == 0 and pool.free_pages == total


def test_write_prefill_lands_in_owned_pages_in_place():
    _, _, cfg, _ = _setup()
    pool = PagedKVPool(cfg, num_pages=6, page_size=4, pages_per_seq=3,
                       dtype=torch.float32, device="cpu")
    k_before = pool.k
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kv = torch.arange(L * 8 * KVH * hd, dtype=torch.float32).reshape(
        L, 8, KVH, hd)
    pool.write_prefill(3, kv, -kv, 7)
    assert pool.k is k_before and pool.kv_len[3] == 7
    row = pool.page_row(3)
    got = pool.k[:, row].reshape(L, -1, KVH, hd)[:, :7]
    assert torch.equal(got, kv[:, :7])
    assert torch.equal(pool.v[:, row].reshape(L, -1, KVH, hd)[:, :7],
                       -kv[:, :7])
    assert not pool.k[:, 0].any()                  # scratch page untouched


def test_engine_slot_reuse_and_no_page_leak():
    _, _, cfg, params = _setup()
    reg = MetricsRegistry()
    eng = _engine(cfg, metrics=reg)
    seqs = [eng.make_sequence([3 + i, 4, 5]) for i in range(5)]
    emitted = []
    fin, paused = eng.generate(params, seqs,
                               emit=lambda q: emitted.append(q.uid))
    assert len(fin) == 5 and not paused
    assert sorted(emitted) == [q.uid for q in sorted(fin, key=lambda q: q.uid)]
    assert eng.pool.pages_in_use == 0 and eng.scheduler.idle
    for q in fin:
        assert len(q.tokens) == 3 + 6
        assert all(np.isfinite(q.logprobs)) and max(q.logprobs) <= 0.0
    snap = reg.snapshot()
    assert sum(v["value"] for v in
               snap["rollout_admissions_total"]["values"]) == 5
    assert snap["rollout_prefill_seconds"]["values"][0]["count"] >= 1
    assert snap["rollout_decode_step_seconds"]["values"][0]["count"] >= 1


def _greedy_tokens(cfg, params, prompt, n, page_size=4, chunk=0):
    eng = _engine(cfg, page_size=page_size, max_new_tokens=n, eos_id=-1,
                  temperature=1.0)
    seq = eng.make_sequence(prompt, chunk=chunk)
    items = [seq]
    while items:
        fin, paused = eng.generate(params, items)
        items = [eng.resume(q, chunk=chunk) for q in paused]
    return seq.tokens


def test_eos_exactly_at_page_boundary():
    _, _, cfg, params = _setup()
    prompt = [5, 6, 7]
    toks = _greedy_tokens(cfg, params, prompt, 9, page_size=4)
    boundary_idx = next(i for i in range(len(prompt) + 1, len(toks))
                        if (i + 1) % 4 == 0)
    eng = _engine(cfg, page_size=4, max_new_tokens=9,
                  eos_id=toks[boundary_idx])
    seq = eng.make_sequence(prompt)
    fin, _ = eng.generate(params, [seq])
    assert fin[0].tokens == toks[:boundary_idx + 1]
    assert fin[0].eos and len(fin[0].tokens) % 4 == 0
    assert eng.pool.pages_in_use == 0 and \
        eng.pool.free_pages == eng.pool.num_pages - 1


def test_parked_continuation_keeps_pages():
    _, _, cfg, params = _setup()
    prompt = [11, 12, 13, 14]
    full = _greedy_tokens(cfg, params, prompt, 8)
    eng = _engine(cfg, max_new_tokens=8, eos_id=-1)
    seq = eng.make_sequence(prompt, chunk=4)
    fin, paused = eng.generate(params, [seq])
    assert paused == [seq] and not fin
    assert eng.pool.owns(seq.uid) and eng.pool.pages_in_use > 0
    fin, paused = eng.generate(params, [eng.resume(seq, chunk=4)])
    assert fin == [seq] and not paused
    assert seq.tokens == full
    assert eng.pool.pages_in_use == 0


def test_preempted_parked_pages_refill_deterministically():
    _, _, cfg, params = _setup()
    prompts = [[5, 6, 7], [8, 9, 10, 11], [3, 4], [250, 251, 252]]

    def run(num_pages):
        eng = _engine(cfg, num_pages=num_pages, max_new_tokens=8, seed=3,
                      metrics=MetricsRegistry())
        items = [eng.make_sequence(p, chunk=3) for p in prompts]
        done = []
        while items:
            fin, paused = eng.generate(params, items)
            done += fin
            items = [eng.resume(q, chunk=3) for q in paused]
        assert eng.pool.pages_in_use == 0
        return {q.uid: q.tokens for q in done}, eng

    roomy, _ = run(None)
    tight, eng = run(9)                   # forces one preemption
    assert tight == roomy
    snap = eng._registry.snapshot()
    assert snap["rollout_preemptions_total"]["values"][0]["value"] > 0


def test_paged_rounds_equal_the_gather_rounds(monkeypatch):
    """The decode rounds read the pool through the page table; forced
    onto the gather route (per-slot views, the row scattered back) they
    give the same tokens and logprobs bit for bit: ragged prompts, chunked
    continuations parked and resumed, one preemption (9 pages)."""
    from repro_torch.engines.continuous_batching import engine as cb

    _, _, cfg, params = _setup()
    prompts = [[5, 6, 7], [8, 9, 10, 11, 12], [3, 4], [250, 251, 252, 253]]

    def run():
        eng = _engine(cfg, num_pages=9, max_new_tokens=8, seed=3,
                      eos_id=-1, metrics=MetricsRegistry())
        items = [eng.make_sequence(p, chunk=3) for p in prompts]
        done = []
        while items:
            fin, paused = eng.generate(params, items)
            done += fin
            items = [eng.resume(q, chunk=3) for q in paused]
        snap = eng._registry.snapshot()
        assert snap["rollout_preemptions_total"]["values"][0]["value"] > 0
        gathered = snap["rollout_kv_gather_bytes_total"]["values"][0]
        return {q.uid: (q.tokens, q.logprobs) for q in done}, \
            gathered["value"]

    paged, none = run()
    monkeypatch.setattr(cb, "_reads_pages", lambda *a: False)
    gathered, some = run()
    assert paged == gathered and len(paged) == len(prompts)
    assert none == 0 and some > 0


# ---------------------------------------------------------------------------
# serve entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["continuous", "fixed"])
def test_serve_main_on_cpu(engine, capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--device", "cpu", "--engine", engine, "--requests", "3",
                     "--max-new-tokens", "4"])
    assert rc == 0
    assert '"device": "cpu"' in capsys.readouterr().out


def test_serve_fleet_not_ported_yet(capsys):
    """The fleet that was refused before it was ported: two replicas
    without faults answer every request, with no restart."""
    import json

    from repro_torch.launch import serve
    assert serve.main(["--device", "cpu", "--engine", "continuous",
                       "--replicas", "2", "--requests", "3",
                       "--max-new-tokens", "4"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["replicas"] == 2 and out["replica_restarts"] == 0
    assert out["requests"] == 3


def test_serve_fleet_requeues_crashed_requests():
    """``--replicas 2 --crash-p`` on the reduced config: injected crashes
    requeue the in-flight request and respawn the replica; every request
    is answered exactly once, in order, and the restarts are counted."""
    from types import SimpleNamespace

    from repro_torch.data import PromptDataset
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("qwen2_5_7b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size)
    params = init_params(0, cfg, device="cpu")
    prompts = PromptDataset(seed=0).prompts_for_step(0, 8)
    args = SimpleNamespace(replicas=2, crash_p=0.25, fault_seed=1, slots=4,
                           max_new_tokens=4, temperature=0.8, seed=0)
    outputs, restarts = serve._serve_fleet(args, cfg, params, prompts,
                                           ByteTokenizer(), "cpu")
    assert restarts >= 1
    assert [o["prompt"] for o in outputs] == [p["text"] for p in prompts]
    assert all(1 <= len(o["response_ids"]) <= 4 for o in outputs)
    assert all(0 <= t < cfg.vocab_size for o in outputs
               for t in o["response_ids"])
