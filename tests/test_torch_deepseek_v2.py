"""DeepSeek-V2 on the port's serving path, at a small size on the CPU,
against the benchmark's plain reference (``perfbench/reference/moe.py``,
plain torch, none of the port): the continuous engine's served logprobs
(prefill, then paged latent decode with slots joining and leaving), the
expert layer's share of the uncut layer, the published routing, the
dropless dispatch, YaRN, and the paged latent route against the dense
latent cache.

The configuration is DeepSeek-V2's block cut small: d 64, 8 heads,
latent r 32 + rope 16, q_lora 48, nope and v 16, 16 experts in 4 groups
(top 2 groups, top 4 experts), 4 held from expert 4 on, one shared, a
dense first layer and 2 MoE layers, every published mechanism on (the
latent norms, YaRN at factor 40, the fp32 gate, unnormalised weights
times 16). Both sides compute in float32 (the reference through a
float32 product in place of ``Precision``'s bf16), so each bar is float32
round-off: 1e-4 through the model (the reference expands the latent where
the decode absorbs it, so the products' order differs), 1e-5 for one
layer. The tests that fix a piece bit for bit say so."""
import json
import math

import numpy as np
import pytest
import torch

from perfbench.core.weights import make
from perfbench.reference import moe as ref
from perfbench.reference.precision import Precision
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, forward, init_cache
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe

MODEL_TOL = 1e-4      # fp32 through the model, latent absorbed vs expanded
LAYER_TOL = 1e-5      # fp32, one expert layer, sums in another order
SEED = 2**33 + 5

PORT = dict(name="deepseek-v2-small", arch_type="moe",
            citation="arXiv:2405.04434", num_layers=3, d_model=64,
            num_heads=8, num_kv_heads=8, head_dim=16, d_ff=96,
            vocab_size=300, attention="mla", kv_lora_rank=32,
            q_lora_rank=48, qk_rope_head_dim=16, qk_nope_head_dim=16,
            v_head_dim=16, mla_latent_norm=True, yarn_factor=40.0,
            yarn_original_positions=4096, yarn_beta_fast=32.0,
            yarn_beta_slow=1.0, yarn_mscale_all_dim=0.707,
            num_experts=16, num_shared_experts=1, top_k=4, moe_d_ff=32,
            first_dense_layers=1, moe_device_limit=2, moe_ep_degree=4,
            moe_router_fp32=True, moe_norm_topk=False, moe_routed_scale=16.0,
            moe_held_first=4, moe_held_experts=4, moe_dropless=True,
            compute_dtype="float32")


class F32(Precision):
    """The reference's products in float32 (``Precision`` rounds them to
    bf16)."""

    def __init__(self):
        self.name, self.act = "f32", torch.float32

    def mm(self, x, w):
        return torch.matmul(x.float(), w.float())


def _params(c=PORT, seed=SEED):
    return make(ref.layout(c), seed, "cpu")


def _tree(t, fn):
    return {k: _tree(v, fn) for k, v in t.items()} if isinstance(t, dict) \
        else fn(t)


def _close(got, want, tol):
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= tol * scale


# -- the served path ----------------------------------------------------------

def test_engine_logprobs_match_the_reference_forward():
    """The continuous engine at 3 slots, pages of 4: 6 requests of ragged
    prompts (prefill buckets of several lengths), decoded through the
    paged latent pool over several rounds while requests finish and
    others take their slots. Each served token's logprob against the
    reference's full forward over the request's tokens."""
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    params = _params()
    eng = ContinuousBatchingEngine(
        ModelConfig(**PORT), num_slots=3, page_size=4, max_len=40,
        max_new_tokens=6, temperature=0.9, eos_id=-1, seed=7,
        dtype=torch.float32, device="cpu")
    assert eng.pool.latent.shape == (3, eng.pool.num_pages, 4, 48)
    assert eng.pool.k is None and eng.pool.v is None
    rng = np.random.default_rng(5)
    seqs = [eng.make_sequence(rng.integers(3, 299, n).tolist(), max_new=m)
            for n, m in ((3, 6), (5, 2), (4, 5), (9, 3), (6, 6), (11, 4))]
    fin, _ = eng.generate(params, seqs)
    assert len(fin) == len(seqs) and not eng.pool.pages_in_use
    for q in fin:
        toks = torch.tensor(q.tokens)[None]
        logits = ref.forward(params, toks, PORT, F32())[0]
        lp = torch.log_softmax(logits / 0.9, dim=-1)
        want = lp[torch.arange(q.prompt_len - 1, len(q.tokens) - 1),
                  toks[0, q.prompt_len:]]
        got = torch.tensor(q.logprobs[q.prompt_len:])
        assert float((got - want).abs().max()) <= MODEL_TOL


def test_engine_records_the_picks_it_served():
    """``record_picks``: every position a request's forwards ran (its
    prompt in a prefill, then one a decode round) has its held picks at
    every MoE layer; the reference routed by them makes the same picks
    itself (fp32: no rounding apart) and the same logprobs."""
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    params = _params()
    eng = ContinuousBatchingEngine(
        ModelConfig(**PORT), num_slots=2, page_size=4, max_len=32,
        max_new_tokens=5, eos_id=-1, seed=2, dtype=torch.float32,
        device="cpu", record_picks=True)
    rng = np.random.default_rng(3)
    fin, _ = eng.generate(params, [eng.make_sequence(
        rng.integers(3, 299, n).tolist()) for n in (4, 9, 6)])
    for q in fin:
        picks = torch.from_numpy(eng.picks_of(q.uid)).long()
        assert picks.shape == (len(q.tokens) - 1, 2, 4)
        assert (picks < 4).any() and picks.max() <= 4
        own = []
        logits = ref.forward(params, torch.tensor(q.tokens)[None], PORT,
                             F32(), picks=picks, own=own)[0]
        mine = torch.stack(own, 1)[:len(q.tokens) - 1]
        assert torch.equal(torch.sort(mine, -1).values,
                           torch.sort(picks, -1).values)
        lp = torch.log_softmax(logits, -1)[
            torch.arange(q.prompt_len - 1, len(q.tokens) - 1),
            torch.tensor(q.tokens[q.prompt_len:])]
        assert float((torch.tensor(q.logprobs[q.prompt_len:]) - lp)
                     .abs().max()) <= MODEL_TOL


def test_engine_counts_by_phase():
    """The engine's counters: live tokens and their query-key pairs by
    phase from the shapes, the held picks and rows from the device (rows
    >= picks: padding and idle slots compute without counting), and the
    latent rows gathered, 48 wide in fp32, one layer at a time."""
    from repro_torch.core.obs import MetricsRegistry
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    params = _params()
    reg = MetricsRegistry()
    eng = ContinuousBatchingEngine(
        ModelConfig(**PORT), num_slots=2, page_size=4, max_len=24,
        max_new_tokens=3, eos_id=-1, seed=1, dtype=torch.float32,
        device="cpu", metrics=reg)
    fin, _ = eng.generate(params, [eng.make_sequence(list(range(3, 3 + n)))
                                   for n in (5, 7)])
    snap = {k: {tuple(sorted(s["labels"].items())): s.get("value")
                for s in v["values"]} for k, v in reg.snapshot().items()}

    def get(name, **lab):
        return snap[name][tuple(sorted({"engine": "cb", **lab}.items()))]
    assert get("rollout_model_tokens_total", phase="prefill") == 12
    assert get("rollout_attended_pairs_total", phase="prefill") == 15 + 28
    # two rounds: positions 5 and 7, then 6 and 8 (one key more each)
    assert get("rollout_model_tokens_total", phase="decode") == 4
    assert get("rollout_attended_pairs_total", phase="decode") == \
        (6 + 8) + (7 + 9)
    for ph in ("prefill", "decode"):
        picks = get("moe_held_picks_total", phase=ph)
        rows = get("moe_expert_rows_total", phase=ph)
        assert 0 < picks <= rows
    # each round gathers the pages of its longest slot: 2 (8 keys) then
    # 3 (9 keys) pages of 4 rows, 2 slots, 3 layers, 48 fp32 wide
    assert get("rollout_kv_gather_bytes_total", kind="latent") == \
        3 * 2 * (8 + 12) * 48 * 4


def test_launcher_serves_deepseek_v2_on_the_continuous_engine(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--device", "cpu", "--arch", "deepseek_v2_236b",
                     "--engine", "continuous", "--requests", "3",
                     "--max-new-tokens", "4"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["engine"] == "continuous" and out["requests"] == 3


@pytest.mark.parametrize("ring", [False, True])
def test_paged_latent_route_equals_the_dense_cache(ring):
    """``mla_decode`` reading a latent pool through shuffled pages against
    the same rows in a dense latent cache, bit for bit (the same products
    on the same rows); a ring is refused on the paged route."""
    cfg = ModelConfig(**PORT)
    p = _tree(_params()["blocks"]["attn"], lambda t: t[0])
    g = torch.Generator().manual_seed(3)
    B, S, ps = 3, 12, 4
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dense = {"c_kv": torch.randn(B, S, r, generator=g),
             "k_rope": torch.randn(B, S, dr, generator=g)}
    table = torch.randperm(B * S // ps, generator=g).view(B, S // ps) + 1
    pool = torch.zeros(1 + B * S // ps, ps, r + dr)
    rows = torch.cat([dense["c_kv"], dense["k_rope"]], -1)
    pool[table.reshape(-1)] = rows.reshape(-1, ps, r + dr)
    pos = torch.tensor([4, 11, 0])
    x = torch.randn(B, 1, cfg.d_model, generator=g)
    cache = tmla.paged_latent_cache(pool, table, pos)
    if ring:
        with pytest.raises(ValueError):
            tmla.mla_decode(p, x, cache, pos, cfg, ring=True)
        return
    with torch.no_grad():
        want, _ = tmla.mla_decode(p, x, dense, pos, cfg)
        got, _ = tmla.mla_decode(p, x, cache, pos, cfg)
    assert torch.equal(got, want)
    # the new rows landed in their pages, as in the dense cache
    back = pool[table].reshape(B, S, r + dr)
    assert torch.equal(back[..., :r], dense["c_kv"])
    assert torch.equal(back[..., r:], dense["k_rope"])


# -- the expert layer ---------------------------------------------------------

def _layer(c, seed=SEED):
    """MoE layer 0's params of the configuration ``c``."""
    return _tree(_params(c, seed)["blocks"]["ffn"], lambda t: t[0])


def test_four_shares_sum_to_the_uncut_layer():
    """Four chips, one routing group of 4 experts each: the partial
    outputs of the four shares (each with the shared expert) less the
    shared expert three times equal the reference's layer holding all 16
    experts."""
    whole = dict(PORT, moe_held_first=0, moe_held_experts=16)
    f = _layer(whole)
    x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(1))
    want = ref.experts(_tree(f, lambda t: t[None]), x, whole, F32(), 0)
    parts = []
    for s in range(4):
        c = dict(PORT, moe_held_first=4 * s, moe_held_experts=4)
        fs = dict(f, experts={k: t[4 * s:4 * s + 4]
                              for k, t in f["experts"].items()})
        with torch.no_grad():
            parts.append(tmoe.moe_ffn(fs, x, ModelConfig(**c))[0])
    from repro_torch.models.layers import mlp
    shared = mlp(f["shared"], x, "silu", torch.float32)
    _close(sum(parts) - 3 * shared, want, LAYER_TOL)


def test_routing_is_the_published_gate():
    """Group-limited greedy: every pick lies in the token's top 2 groups
    by their best score; weights are the softmax scores (not renormalised)
    times 16; the gate's product is fp32 even on bf16 inputs; ties go to
    the lower index."""
    cfg = ModelConfig(**PORT)
    f = _layer(PORT)
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(2))
    probs = tmoe._router_probs(f, x.bfloat16(), cfg)
    assert torch.equal(probs, torch.softmax(
        x.bfloat16().float() @ f["router"]["w"], -1))
    w, ids, _ = tmoe.route(probs, cfg)
    groups = torch.sort(probs.view(40, 4, 4).amax(-1), dim=-1, descending=True,
                        stable=True).indices[:, :2]
    assert all(set((ids[n] // 4).tolist()) <= set(groups[n].tolist())
               for n in range(40))
    assert torch.equal(w, probs.gather(1, ids) * 16)
    assert (w.sum(-1) < 16).all()
    tied = torch.full((1, 16), 1 / 16)
    _, ids, _ = tmoe.route(tied, cfg)
    assert ids.tolist() == [[0, 1, 2, 3]]


def test_dropless_dispatch_keeps_every_pick():
    """Every token picks held expert 5 (the router's column for it reads
    a direction every token leans in): 24 tokens' picks into one expert,
    over the capacity of 8 a capacity route keeps. The dropless layer
    equals the reference; the capacity route, given the same picks, does
    not."""
    f = _layer(PORT)
    x = torch.randn(2, 12, 64, generator=torch.Generator().manual_seed(4))
    x[..., 0] += 3.0                     # every token leans one way
    f["router"]["w"][:, 5] = 0.0
    f["router"]["w"][0, 5] = 10.0        # expert 5's logit ~30, others ~0
    _, ids, _ = tmoe.route(tmoe._router_probs(
        f, x.reshape(24, 64), ModelConfig(**PORT)), ModelConfig(**PORT))
    assert (ids == 5).any(-1).all()
    want = ref.experts(_tree(f, lambda t: t[None]), x, PORT, F32(), 0)
    with torch.no_grad():
        got, _ = tmoe.moe_ffn(f, x, ModelConfig(**PORT))
        capped, _ = tmoe.moe_ffn(f, x, ModelConfig(**dict(
            PORT, moe_dropless=False)))
    _close(got, want, LAYER_TOL)
    assert float((capped - want).abs().max()) > 100 * LAYER_TOL


# -- YaRN ---------------------------------------------------------------------

def test_yarn_frequencies_and_factor_at_the_published_sizes():
    """64 rope dims, theta 1e4, factor 40, 4096 original positions,
    beta 32 and 1: the correction range is dims 10 to 23; below it the
    plain frequencies, above it over 40, a linear blend between. m =
    0.1 * 0.707 * ln 40 + 1 = 1.2608, and the softmax scale is
    192^-0.5 * m^2. The port's and the reference's tables agree."""
    dim, theta = 64, 10000.0
    got = tmla.yarn_freqs(dim, theta, 40.0, 4096, 32.0, 1.0)
    plain = 1.0 / theta ** (np.arange(0, dim, 2) / dim)
    for i in range(dim // 2):
        ramp = min(max((i - 10) / 13, 0.0), 1.0)
        want = plain[i] / 40 * ramp + plain[i] * (1 - ramp)
        assert got[i] == pytest.approx(want, rel=1e-6)
    assert got[10] == pytest.approx(plain[10], rel=1e-6)
    assert got[23] == pytest.approx(plain[23] / 40, rel=1e-6)
    c = dict(PORT, qk_rope_head_dim=64, qk_nope_head_dim=128)
    np.testing.assert_allclose(ref.yarn_inv_freq(c, dim).numpy(), got,
                               rtol=1e-6)
    m = tmla.yarn_mscale(40.0, 0.707)
    assert m == pytest.approx(1.2608, abs=1e-4)
    cfg = ModelConfig(**c)
    assert tmla._scale(cfg) == pytest.approx(192 ** -0.5 * m * m)
    assert ref.attention_factor(c) == pytest.approx(m * m)
    off = ModelConfig(**dict(c, yarn_factor=1.0, yarn_mscale_all_dim=0.0))
    assert tmla._scale(off) == 192 ** -0.5


def test_decode_continues_the_forward_through_a_dense_cache():
    """The absorbed decode with the latent norms and YaRN on, over a dense
    latent cache, continues the port's own forward (the fixed engine's
    route), every token's logits within the model's bar."""
    cfg = ModelConfig(**PORT)
    params = _params()
    toks = torch.from_numpy(np.random.default_rng(8).integers(3, 299,
                                                              (2, 10)))
    with torch.no_grad():
        want, _ = forward(params, cfg, {"tokens": toks})
        cache = init_cache(cfg, 2, 10, dtype=torch.float32, device="cpu")
        for t in range(10):
            lt, cache = decode_step(params, cfg, cache, toks[:, t],
                                    torch.full((2,), t))
            _close(lt, want[:, t], MODEL_TOL)
    assert math.isfinite(float(want.abs().max()))
