"""The port on the card: each CUDA kernel against its plain PyTorch version,
the fused loss's autograd Function, the serving engine on CUDA against a
CPU forward, and the trainer on the card. Every test takes the
``cuda_device`` fixture and skips where there is no card. The file imports
neither JAX nor the reference, so on a machine with a card and no JAX it
runs alone: ``PYTHONPATH=src python -m pytest --noconftest
tests/test_torch_cuda.py``."""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.fused_rl_loss import (fused_rl_loss,
                                               fused_rl_loss_bwd,
                                               fused_rl_loss_bwd_ref,
                                               fused_rl_loss_bwd_tolerance,
                                               fused_rl_loss_fwd,
                                               fused_rl_loss_fwd_ref,
                                               fused_rl_loss_oracle)
from repro_torch.kernels.fused_rl_loss.ref import \
    _epilogue as fused_epilogue
from repro_torch.kernels.grpo_logprob import grpo_logprob, grpo_logprob_ref
from repro_torch.kernels.grpo_logprob.ref import split_bounds
from repro_torch.kernels.mamba_scan import (mamba_scan, mamba_scan_ref,
                                            scan_from)
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
from repro_torch.tree import tree_map

# fp32: summation order differs on the card; bf16: one rounding of the output
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# fused_rl_loss backward: relative to each element of dx (one rounding)
DX_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


# (B, Sq, Sk, H, KV, hd). The first eight are the serving and hybrid shapes;
# then the bf16 kernel's tile edges (128-row Q tiles of two 64-row halves,
# K/V tiles of 128 keys, 32 at hd 256): S of 1, 63, 64, 65, 127, 128, 129
# and 77 (off the 8-grid), Sq < Sk, and groups of 1, 7 and 16 at every hd.
FLASH_SHAPES = [
    (1, 128, 128, 4, 4, 64), (2, 256, 256, 4, 2, 64), (1, 256, 256, 8, 1, 32),
    (2, 128, 128, 4, 4, 128), (2, 100, 100, 4, 2, 64),
    (4, 1000, 1000, 28, 4, 128), (1, 300, 300, 16, 1, 256),
    (2, 130, 130, 16, 1, 256),
    (1, 1, 1, 7, 1, 128), (2, 63, 63, 4, 2, 64), (1, 64, 64, 16, 1, 256),
    (2, 65, 65, 7, 1, 32), (1, 127, 127, 4, 4, 128), (1, 128, 128, 16, 1, 64),
    (2, 129, 129, 7, 1, 256), (1, 77, 77, 4, 2, 128),
    (2, 100, 260, 7, 1, 128), (1, 33, 64, 16, 1, 256), (1, 129, 300, 4, 2, 32),
    (1, 1, 17, 4, 1, 64),
    # hd 160 (StableLM-2-12B; bf16 runs it at 192 with 64-key tiles): its
    # 32/8 heads, a group of 7, the 64-key tile's edges, Sq < Sk
    (1, 300, 300, 32, 8, 160), (2, 129, 129, 7, 1, 160), (1, 65, 65, 4, 2, 160),
    (2, 63, 130, 4, 4, 160),
    # Grok-1's and InternVL2-26B's 48/8 heads at hd 128 (a group of 6): a
    # bucketed prefill, and a vision prefix of 1024 with a short prompt
    (4, 256, 256, 48, 8, 128), (1, 1040, 1040, 48, 8, 128),
    # Whisper-tiny's decoder: 6 query heads on 6 KV heads (a group of 1)
    # at hd 64, 64 teacher-forced tokens
    (4, 64, 64, 6, 6, 64)]
# none, 1, one K/V tile at hd 256 (32), 64, one tile below hd 256 (128),
# wider than any S
FLASH_WINDOWS = [0, 1, 32, 64, 128, 4096]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", FLASH_WINDOWS)
def test_flash_kernel_matches_plain(cuda_device, B, Sq, Sk, H, KV, hd, dtype,
                                    window):
    """bf16 runs on wgmma (P rounded to bf16 before P V), fp32 on the FP32
    cores; both within TOL of the plain version (fp32 P throughout)."""
    gen = torch.Generator(device=cuda_device).manual_seed(Sq + Sk + hd)
    q = _randn(gen, (B, Sq, H, hd), dtype, cuda_device)
    k = _randn(gen, (B, Sk, KV, hd), dtype, cuda_device)
    v = _randn(gen, (B, Sk, KV, hd), dtype, cuda_device)
    n = flash_attention.launches
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    ref = flash_attention_ref(q, k, v, window=window)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_flash_kernel_fp32_route(cuda_device):
    """An fp32 call at Qwen2.5-7B's heads keeps the FP32-core route: one
    launch, within 1e-4 + 1e-4 |ref| of the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(32)
    q = _randn(gen, (2, 300, 28, 128), torch.float32, cuda_device)
    k = _randn(gen, (2, 300, 4, 128), torch.float32, cuda_device)
    v = _randn(gen, (2, 300, 4, 128), torch.float32, cuda_device)
    n = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1 and out.dtype == torch.float32
    _assert_close_rel(out, flash_attention_ref(q, k, v), 1e-4)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 1024, 4, 2, 64), (1, 2048, 8, 8, 32), (3, 512, 4, 1, 128),
    (3, 100, 4, 2, 64), (4, 4099, 28, 4, 128), (2, 5, 16, 1, 64),
    (4, 2048, 16, 1, 256), (3, 77, 16, 1, 256), (4, 2080, 32, 8, 160),
    (4, 2080, 48, 8, 128), (4, 1064, 48, 8, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(cuda_device, B, S, H, KV, hd, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(S + hd)
    q = _randn(gen, (B, 1, H, hd), dtype, cuda_device)
    k = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    v = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    fill = np.random.default_rng(S).integers(1, S + 1, size=B)
    fill[0] = 0                          # no valid key: uniform average
    valid = torch.from_numpy(np.arange(S)[None, :] < fill[:, None]).to(
        cuda_device)
    n = decode_attention.launches
    out = decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    ref = decode_attention_ref(q, k, v, valid)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _holes(rng, B, S):
    """Masks that are not prefixes: row 0 random holes, row 1 no valid key
    (the uniform average), row 2 only its last key, the rest holes."""
    valid = rng.random((B, S)) < 0.35
    valid[1] = False
    valid[2] = False
    valid[2, -1] = True
    return valid


@pytest.mark.parametrize("hd", [32, 64, 128, 160, 256])
@pytest.mark.parametrize("G", [1, 4, 7, 16, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_masks_groups_and_head_dims(cuda_device, hd, G,
                                                  dtype):
    """Every head dim and GQA group (32: two groups of 16 rows) over 2 KV
    heads and 300 keys (not a whole number of 64-key tiles), with masks
    that are not prefixes, a row with no valid key and a row whose only
    valid key is its last."""
    B, S, KV = 4, 300, 2
    gen = torch.Generator(device=cuda_device).manual_seed(hd * 41 + G)
    q = _randn(gen, (B, 1, G * KV, hd), dtype, cuda_device)
    k = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    v = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    valid = torch.from_numpy(_holes(np.random.default_rng(hd + G), B,
                                    S)).to(cuda_device)
    out = decode_attention(q, k, v, valid)
    ref = decode_attention_ref(q, k, v, valid)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd", [(3, 1, 28, 4, 128),
                                         (64, 300, 28, 4, 128),
                                         (64, 80, 16, 1, 256)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_one_key_and_many_rows(cuda_device, B, S, H, KV, hd,
                                             dtype):
    """S = 1 (one key, valid or not), and B = 64 (one split a row)."""
    gen = torch.Generator(device=cuda_device).manual_seed(B + S)
    q = _randn(gen, (B, 1, H, hd), dtype, cuda_device)
    k = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    v = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    valid = np.ones((B, S), bool) if S == 1 else _holes(
        np.random.default_rng(B), B, S)
    valid[0] = False
    valid = torch.from_numpy(valid).to(cuda_device)
    out = decode_attention(q, k, v, valid)
    ref = decode_attention_ref(q, k, v, valid)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_on_a_full_ring_at_hd256(cuda_device, dtype):
    """RecurrentGemma's decode: 16 query heads on 1 KV head, hd 256, every
    key of a 2048-key ring valid."""
    gen = torch.Generator(device=cuda_device).manual_seed(256)
    q = _randn(gen, (4, 1, 16, 256), dtype, cuda_device)
    k = _randn(gen, (4, 2048, 1, 256), dtype, cuda_device)
    v = _randn(gen, (4, 2048, 1, 256), dtype, cuda_device)
    valid = torch.ones((4, 2048), dtype=torch.bool, device=cuda_device)
    out = decode_attention(q, k, v, valid)
    ref = decode_attention_ref(q, k, v, valid)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _paged_inputs(gen, rng, B, S, KV, hd, ps, lens, dtype, device):
    """Pools and a page table as the continuous engine lays them: each row
    owns distinct, shuffled pages for its ``lens`` keys (a row of length 1
    is an idle slot: all of its table on the reserved page 0, one valid
    key), page 0 past them; spare pages in the pool too."""
    need = [0 if n == 1 else -(-n // ps) for n in lens]
    NP = 1 + sum(need) + 7
    ids = rng.permutation(np.arange(1, NP))
    table = np.zeros((B, S // ps), np.int64)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = ids[at:at + n]
        at += n
    k_pool, v_pool = (_randn(gen, (NP, ps, KV, hd), dtype, device)
                      for _ in range(2))
    valid = np.arange(S)[None, :] < np.asarray(lens)[:, None]
    return (k_pool, v_pool, torch.from_numpy(table).to(device),
            torch.from_numpy(valid).to(device))


@pytest.mark.parametrize("H,KV,hd", [(28, 4, 128), (32, 8, 160),
                                     (16, 1, 256)])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_kernel_equals_dense_on_the_gathered_view(
        cuda_device, H, KV, hd, ps, dtype):
    """The paged mode reads each row's keys through its page table and
    gives bit for bit what the dense mode gives on the gathered views:
    rows of 1 key (an idle slot on page 0), 63/64/65 (a tile's edges), a
    split's edges, 2304 (every key) and one drawn at random, over 2304
    keys; one launch a call, named ``decode_kernel`` in the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention.ops import _num_sms, _splits
    B, S = 8, 2304
    chunk = _splits(_num_sms(cuda_device.index), B, S, H, KV)[1]
    rng = np.random.default_rng(hd + ps)
    lens = [1, 63, 64, 65, chunk, chunk + 1, S, int(rng.integers(2, S))]
    gen = torch.Generator(device=cuda_device).manual_seed(hd * ps)
    q = _randn(gen, (B, 1, H, hd), dtype, cuda_device)
    k_pool, v_pool, table, valid = _paged_inputs(
        gen, rng, B, S, KV, hd, ps, lens, dtype, cuda_device)
    n = decode_attention.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = paged_decode_attention(q, k_pool, v_pool, table, valid)
        torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    names = [e.key for e in prof.key_averages()]
    assert any(re.search(r"\bdecode_kernel\b", k) for k in names), names
    k, v = (p[table].reshape(B, S, KV, hd) for p in (k_pool, v_pool))
    assert torch.equal(out, decode_attention(q, k, v, valid))


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_kernel_at_the_rollout_shape(cuda_device, dtype):
    """The rollout cell's decode: 256 slots of 2304 keys in pages of 8,
    Qwen2.5-7B's 28/4 heads at hd 128 (one split a row), ragged rows and
    idle slots; bit for bit the dense mode on the gathered views."""
    B, S, H, KV, hd, ps = 256, 2304, 28, 4, 128, 8
    rng = np.random.default_rng(256)
    lens = [1 if b % 9 == 0 else int(rng.integers(2, S + 1))
            for b in range(B)]
    gen = torch.Generator(device=cuda_device).manual_seed(256)
    q = _randn(gen, (B, 1, H, hd), dtype, cuda_device)
    k_pool, v_pool, table, valid = _paged_inputs(
        gen, rng, B, S, KV, hd, ps, lens, dtype, cuda_device)
    out = paged_decode_attention(q, k_pool, v_pool, table, valid)
    k, v = (p[table].reshape(B, S, KV, hd) for p in (k_pool, v_pool))
    assert torch.equal(out, decode_attention(q, k, v, valid))


def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda_device):
    q = torch.zeros((1, 8, 2, 48), device=cuda_device)     # hd 48
    ones = torch.ones((1, 8), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="unsupported shapes"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported shapes"):
        decode_attention(q[:, :1], q, q, ones)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, q.cpu(), q)
    q = torch.zeros((1, 8, 2, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention(q, q, q)


def _to_cpu(tree):
    return tree_map(lambda t: t.cpu(), tree)


@pytest.mark.parametrize("arch,head_dim", [("qwen2_5_7b", 64),
                                           ("stablelm_12b", 160)])
def test_engine_on_card_matches_cpu_forward(cuda_device, arch, head_dim):
    """Serve a reduced model on the card (both kernels run), then score the
    sampled tokens with a CPU forward over the same weights (fp32).
    StableLM-2-12B keeps its head dim of 160."""
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.models import forward, init_params

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              vocab_size=ByteTokenizer.vocab_size,
                              head_dim=head_dim, compute_dtype="float32")
    params = init_params(0, cfg, device=cuda_device)
    eng = ContinuousBatchingEngine(cfg, num_slots=2, max_len=64,
                                   max_new_tokens=6, eos_id=-1,
                                   dtype=torch.float32, device=cuda_device)
    rng = np.random.default_rng(0)
    seqs = [eng.make_sequence(rng.integers(3, 259, n)) for n in (5, 17, 9)]
    n_d, n_f = decode_attention.launches, flash_attention.launches
    fin, _ = eng.generate(params, seqs)
    assert decode_attention.launches > n_d and flash_attention.launches > n_f
    assert len(fin) == 3 and eng.pool.pages_in_use == 0
    cpu = _to_cpu(params)
    for q in fin:
        toks = torch.tensor(q.tokens)[None]
        with torch.no_grad():
            logits, _ = forward(cpu, cfg, {"tokens": toks})
        logp = torch.log_softmax(logits[0].float(), dim=-1)
        want = [logp[t - 1, q.tokens[t]].item()
                for t in range(q.prompt_len, len(q.tokens))]
        np.testing.assert_allclose(q.logprobs[q.prompt_len:], want,
                                   atol=1e-4, rtol=1e-4)


# The vocab-streaming kernels at the trainer's shapes: a micro-batch of
# 4 rows x 79 tokens, 4096 rows, full Qwen2.5 vocab, full Falcon-Mamba
# vocab (65,024) and full RecurrentGemma vocab (256,000); V=259 (byte
# vocab: bf16 rows start at 518-byte offsets, off the 16-byte grid) and
# 2053; Grok-1's 131,072 at its micro-batch of 16 x 79 rows, and
# InternVL2-26B's odd 92,553 at 8 x 79 (rows off the 16-byte grid at full
# width); MiniCPM3-4B's 73,448 at the trainer's 4 x 79, DeepSeek-V2's
# 102,400 at its micro-batch of 16 x 79, and Whisper-tiny's odd 51,865 at
# its micro-batch of 16 x 79.
VOCAB_SHAPES = [(7, 259), (5, 2053), (316, 152064), (4096, 152064),
                (316, 65024), (4096, 65024), (316, 256000), (1264, 131072),
                (632, 92553), (7, 92553), (316, 73448), (1264, 102400),
                (1264, 51865)]
# blocks a row in the vocab pass: 0 leaves the choice to the C entry
VOCAB_SPLITS = [0, 1, 2, 4, 8]


def _loss_inputs(gen, N, V, dtype, device):
    x = (4 * torch.randn((N, V), generator=gen, device=device)).to(dtype)
    t = torch.randint(0, V, (N,), generator=gen, device=device)
    old = torch.randn(N, generator=gen, device=device) * 0.3 - 5.0
    ref = old + 0.1 * torch.randn(N, generator=gen, device=device)
    adv = torch.randn(N, generator=gen, device=device)
    return x, t, old, ref, adv


def _assert_close_rel(out, ref, tol):
    """|out - ref| <= tol + tol*|ref| elementwise."""
    out, ref = out.float(), ref.float()
    bad = (out - ref).abs() > tol + tol * ref.abs()
    assert not bool(bad.any()), float((out - ref).abs().max())


@pytest.mark.parametrize("N,V", VOCAB_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nsplit", VOCAB_SPLITS)
def test_vocab_kernels_match_plain(cuda_device, N, V, dtype, nsplit):
    """grpo_logprob and fused_rl_loss forward, at the entry's own split
    (0) and at each forced one: the (N,) fp32 outputs within 1e-4 +
    1e-4*|ref| in both input dtypes (bf16 converts to fp32 exactly on
    load); backward dx from the forward's lse within 1e-4 (fp32) or 1e-2
    (bf16, one rounding) of each element, plus 1e-5 of its terms where
    they cancel (``fused_rl_loss_bwd_tolerance``). Each wrapper call counts
    one launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(N + V)
    x, t, old, ref, adv = _loss_inputs(gen, N, V, dtype, cuda_device)
    n = (grpo_logprob.launches, fused_rl_loss_fwd.launches,
         fused_rl_loss_bwd.launches)
    lp, ent = grpo_logprob(x, t, nsplit=nsplit)
    outs = fused_rl_loss_fwd(x, t, old, ref, adv, nsplit=nsplit)
    dlp = torch.randn(N, generator=gen, device=cuda_device)
    g_ent = torch.randn(N, generator=gen, device=cuda_device)
    dx = fused_rl_loss_bwd(x, t, outs[5], outs[5] - outs[1], dlp, g_ent)
    torch.cuda.synchronize()
    assert (grpo_logprob.launches, fused_rl_loss_fwd.launches,
            fused_rl_loss_bwd.launches) == tuple(c + 1 for c in n)
    for o, r in zip((lp, ent), grpo_logprob_ref(x, t)):
        _assert_close_rel(o, r, 1e-4)
    for o, r in zip(outs, fused_rl_loss_fwd_ref(x, t, old, ref, adv)):
        _assert_close_rel(o, r, 1e-4)
    assert dx.dtype == dtype and dx.shape == x.shape
    stats = (outs[5], outs[5] - outs[1], dlp, g_ent)
    want = fused_rl_loss_bwd_ref(x, t, *stats)
    limit = fused_rl_loss_bwd_tolerance(x, t, *stats, want, DX_RTOL[dtype])
    err = (dx.float() - want.float()).abs()
    assert bool((err <= limit).all()), float((err / limit).max())


def _edge_rows(x, V, nsplit):
    """Per row of ``x``, a target next to one of the row's split
    boundaries (from the row's own 16-byte head), column 0 and V-1, and
    out-of-range ones; every third row gets its max in the first split.
    Returns the (N,) int64 targets."""
    vec = 16 // x.element_size()
    picks = []
    for r in range(x.shape[0]):
        head = (-(x[r].data_ptr() % 16) % 16) // x.element_size()
        cols = {0, V - 1, -1, V, V + 5}
        for lo, hi in split_bounds(V, nsplit, vec, min(head, V)):
            cols.update(c for c in (lo - 1, lo, hi - 1, hi) if 0 <= c < V)
        cols = sorted(cols)
        picks.append(cols[r % len(cols)])
    x[::3, 0] = 40.0
    return torch.tensor(picks, device=x.device)


@pytest.mark.parametrize("V", [259, 2053])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nsplit", VOCAB_SPLITS)
def test_vocab_kernels_edge_targets(cuda_device, V, dtype, nsplit):
    """Both forward kernels with targets in column 0, in column V-1, on
    every split boundary and out of range (the pick is 0: lp = -lse, as
    the Pallas kernel's never-set g), and rows whose max lies in another
    split than their target: within 1e-4 + 1e-4*|ref| of the plain
    versions (out-of-range rows: lp = -lse and the epilogue on it)."""
    gen = torch.Generator(device=cuda_device).manual_seed(V + nsplit)
    N = 48
    x, _, old, ref, adv = _loss_inputs(gen, N, V, dtype, cuda_device)
    t = _edge_rows(x, V, max(nsplit, 1))
    inside = (t >= 0) & (t < V)
    assert bool((~inside).any()) and bool(inside.any())
    n = (grpo_logprob.launches, fused_rl_loss_fwd.launches)
    lp, ent = grpo_logprob(x, t, nsplit=nsplit)
    outs = fused_rl_loss_fwd(x, t, old, ref, adv, nsplit=nsplit)
    torch.cuda.synchronize()
    assert (grpo_logprob.launches, fused_rl_loss_fwd.launches) == \
        (n[0] + 1, n[1] + 1)
    safe = torch.where(inside, t, torch.zeros_like(t))
    f = fused_rl_loss_fwd_ref(x, safe, old, ref, adv)
    want_lp = torch.where(inside, f[0], -f[5])
    _assert_close_rel(lp, want_lp, 1e-4)
    _assert_close_rel(ent, f[1], 1e-4)
    kl, pl, ratio = fused_epilogue(want_lp, old, ref, adv, 0.2)
    for o, w in zip(outs, (want_lp, f[1], kl, pl, ratio, f[5])):
        _assert_close_rel(o, w, 1e-4)


@pytest.mark.parametrize("N,V", [(13, 259), (9, 2053)])
def test_fused_rl_loss_function_backward_on_card(cuda_device, N, V):
    """The autograd Function's gradients (kernel backward for dlogits) vs
    autograd through the unfused oracle, fp32, within 1e-4 relative."""
    gen = torch.Generator(device=cuda_device).manual_seed(V)
    x, t, old, ref, adv = _loss_inputs(gen, N, V, torch.float32,
                                       cuda_device)
    cts = [torch.randn(N, generator=gen, device=cuda_device)
           for _ in range(5)]
    grads = []
    for fn in (fused_rl_loss, fused_rl_loss_oracle):
        ins = [a.clone().requires_grad_() for a in (x, old, ref, adv)]
        outs = fn(ins[0], t, *ins[1:])
        total = sum((o * c).sum() for o, c in zip(outs, cts))
        grads.append(torch.autograd.grad(total, ins))
    for g, w in zip(*grads):
        assert float((g - w).norm() / w.norm()) < 1e-4


def test_flash_raises_under_grad_on_card(cuda_device):
    q = torch.zeros((1, 8, 2, 64), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q, q)
    with torch.no_grad():
        assert flash_attention(q, q, q).shape == q.shape


def test_grpo_grads_on_card_match_cpu(cuda_device):
    """One GRPO micro-batch of a reduced model, fp32 compute: the card's
    gradients (plain attention route, fused-loss kernels) match the CPU's
    within 1e-4 relative, and the attention weights get their gradient."""
    from repro_torch.engines import pack_rows
    from repro_torch.models import init_params
    from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("qwen2_5_7b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size,
                              compute_dtype="float32")
    params = init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    rows = {"response": [rng.integers(3, 259, 20) for _ in range(4)],
            "logprob": [np.full(20, -5.5, np.float32)] * 4,
            "response_mask": [np.r_[np.zeros(5), np.ones(15)]] * 4,
            "advantage": [1.0, -1.0, 0.5, -0.5],
            "ref_logprob": [np.full(20, -5.4, np.float32)] * 4}
    rl = GRPOConfig(kl_coef=0.1)
    n = fused_rl_loss_bwd.launches
    g_cpu, m_cpu = grpo_grad_step(params, cfg, rl,
                                  pack_rows(rows, 24, "cpu"))
    g_gpu, m_gpu = grpo_grad_step(_to(params, cuda_device), cfg, rl,
                                  pack_rows(rows, 24, cuda_device))
    assert fused_rl_loss_bwd.launches == n + 1
    for k in m_cpu:
        assert abs(float(m_gpu[k]) - float(m_cpu[k])) <= 1e-4 * (
            1 + abs(float(m_cpu[k])))
    for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)):
        assert float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30)) < 1e-4
    for w in ("wq", "wk", "wv"):
        assert float(g_gpu["blocks"]["attn"][w]["w"].abs().max()) > 0


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def test_trainer_on_card_launches_every_kernel(cuda_device):
    """A reduced GRPO run with KL on the continuous backend: every kernel
    of the training path launches, staleness stays in bound."""
    from repro_torch.api import Trainer, TrainerConfig
    counters = (flash_attention, decode_attention, grpo_logprob,
                fused_rl_loss_fwd, fused_rl_loss_bwd)
    before = [c.launches for c in counters]
    res = Trainer(TrainerConfig(num_steps=2, prompts_per_step=2,
                                group_size=2, max_new_tokens=4, seq_len=24,
                                kl_coef=0.05,
                                rollout_backend="continuous")).fit()
    assert res.samples_trained == 8 and max(res.staleness_seen) <= 2
    assert all(c.launches > b for c, b in zip(counters, before))


# The selective scan at the reference kernel test's shapes and its
# distributions (A = -|normal|), ragged S and D, the trainer's
# reference-inference rows (16 x 80 at Falcon-Mamba's d_inner) and the long
# prefill. Over long S, channels with A near 0 carry their state with a gain
# of 1/(1 - exp(dt A)) (thousands at |A| ~ 1e-3), which scales up the 1-2
# ulp rounding of exp in either fp32 version beyond 1e-4; the long shapes
# take the model's ranges instead (A = -(1..N) as a_log's init, dt near
# softplus(-4.6)), and the kernel is held to a float64 scan there.
# (B, S, D, N, dist): the main path's rows (4 x 80 in the trainers'
# reference inference, 1 x 80 a teacher-forced forward, 4 x 79 and
# 2 x 79), one step, the short path's threshold and one step past it,
# ragged D with N = 8, the reference test's shapes, 16 x 80 and the long
# prefill
SCAN_SHAPES = [(4, 80, 8192, 16, "model"), (1, 80, 8192, 16, "model"),
               (4, 79, 8192, 16, "model"), (2, 79, 96, 16, "reference"),
               (1, 1, 8192, 16, "model"), (4, 128, 8192, 16, "model"),
               (4, 129, 8192, 16, "model"), (3, 80, 100, 8, "reference"),
               (1, 128, 128, 16, "reference"), (2, 256, 256, 8, "reference"),
               (1, 33, 40, 8, "reference"), (16, 80, 8192, 16, "reference"),
               (1, 2048, 8192, 16, "model")]
# (B, S, W): the main path's rows, one step, the threshold and one past
# it, ragged S and W, the long prefill
RGLRU_SHAPES = [(4, 80, 4096), (1, 80, 4096), (4, 79, 4096), (2, 79, 4096),
                (4, 128, 4096), (4, 129, 4096), (1, 2048, 4096),
                (3, 77, 1000), (2, 33, 4099), (1, 1, 5)]


def _scan_inputs(gen, B, S, D, N, dist, device):
    """x, dt, a, and B and C as strided views of one projection output."""
    x = _randn(gen, (B, S, D), torch.float32, device)
    z = _randn(gen, (B, S, D), torch.float32, device)
    if dist == "reference":
        dt = 0.1 * torch.nn.functional.softplus(z)
        a = -_randn(gen, (D, N), torch.float32, device).abs()
    else:
        dt = torch.nn.functional.softplus(0.5 * z - 4.6)
        a = -torch.arange(1, N + 1, dtype=torch.float32,
                          device=device).expand(D, N).contiguous()
    dbc = _randn(gen, (B, S, 7 + 2 * N), torch.float32, device)
    return x, dt, a, dbc[..., 7:7 + N], dbc[..., 7 + N:]


@pytest.mark.parametrize("B,S,D,N,dist", SCAN_SHAPES)
def test_mamba_scan_kernel_matches_plain(cuda_device, B, S, D, N, dist):
    """fp32, |err| <= 1e-4 + 1e-4 |ref| (the sums run in another order);
    B and C are strided views of one projection output, as in the model."""
    gen = torch.Generator(device=cuda_device).manual_seed(S + D)
    x, dt, a, b, c = _scan_inputs(gen, B, S, D, N, dist, cuda_device)
    assert b.stride(1) == 7 + 2 * N          # a view, not a copy
    n = mamba_scan.launches
    y = mamba_scan(x, dt, a, b, c)
    torch.cuda.synchronize()
    assert mamba_scan.launches == n + 1
    assert y.dtype == torch.float32 and y.shape == (B, S, D)
    _assert_close_rel(y, mamba_scan_ref(x, dt, a, b, c), 1e-4)


@pytest.mark.parametrize("dist", ["reference", "model"])
def test_mamba_scan_kernel_is_as_close_to_fp64_as_plain(cuda_device, dist):
    """At the long prefill, against the recurrence in float64: the kernel's
    largest error is within twice the plain fp32 version's (plus 1e-6),
    with the reference test's A = -|normal| too."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    ins = _scan_inputs(gen, 1, 2048, 8192, 16, dist, cuda_device)
    h0 = torch.zeros((1, 8192, 16), dtype=torch.float64, device=cuda_device)
    truth = scan_from(*(t.double() for t in ins), h0)[0]
    with torch.no_grad():
        err_k = (mamba_scan(*ins).double() - truth).abs().max().item()
    err_p = (mamba_scan_ref(*ins).double() - truth).abs().max().item()
    assert err_k <= 2 * err_p + 1e-6, (err_k, err_p)


@pytest.mark.parametrize("B,S,D,N", [(4, 80, 8192, 16), (1, 1, 96, 8),
                                     (4, 128, 8192, 16), (3, 77, 100, 8)])
@pytest.mark.parametrize("path", [1, 2])
def test_mamba_scan_forced_paths_match_plain(cuda_device, B, S, D, N, path):
    """Each path of the entry (1 short, 2 long) wherever both take S, B
    and C strided views of one projection, |err| <= 1e-4 + 1e-4 |ref|."""
    gen = torch.Generator(device=cuda_device).manual_seed(S + path)
    ins = _scan_inputs(gen, B, S, D, N, "model", cuda_device)
    with torch.no_grad():
        y = mamba_scan(*ins, path=path)
    _assert_close_rel(y, mamba_scan_ref(*ins), 1e-4)


@pytest.mark.parametrize("dist", ["reference", "model"])
def test_mamba_scan_short_path_is_as_close_to_fp64_as_plain(cuda_device,
                                                            dist):
    """At the trainers' 4 x 80 rows (the short path), as the long
    prefill's test holds the long path."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    ins = _scan_inputs(gen, 4, 80, 8192, 16, dist, cuda_device)
    h0 = torch.zeros((4, 8192, 16), dtype=torch.float64, device=cuda_device)
    truth = scan_from(*(t.double() for t in ins), h0)[0]
    with torch.no_grad():
        err_k = (mamba_scan(*ins).double() - truth).abs().max().item()
    err_p = (mamba_scan_ref(*ins).double() - truth).abs().max().item()
    assert err_k <= 2 * err_p + 1e-6, (err_k, err_p)


def test_scan_path_mirrors_pick_what_the_entries_pick(cuda_device):
    """``path_for`` of each wrapper against its C entry's rule at S = 1,
    79, 80, the threshold and one past it (``mamba_scan`` at 1 and 4 rows
    of 8192 channels on this card); the short path refuses S past the
    threshold."""
    from repro_torch.kernels import _build
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    T = rglru_ops.SHORT_MAX
    for S in (1, 79, 80, T, T + 1):
        assert _build.kernel("rglru_scan_path")(S) == rglru_ops.path_for(S)
    T = mamba_ops.SHORT_MAX
    for B in (1, 4):
        for S in (1, 79, 80, T, T + 1):
            assert _build.kernel("mamba_scan_path")(B, S, 8192, n_sm) == \
                mamba_ops.path_for(B, S, 8192, n_sm)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x, dt, a, b, c = _scan_inputs(gen, 1, T + 1, 64, 8, "model", cuda_device)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="launch failed"):
            mamba_scan(x, dt, a, b, c, path=1)
        with pytest.raises(RuntimeError, match="launch failed"):
            rglru_scan(dt, x, path=1)


def test_mamba_scan_raises_under_grad_on_card(cuda_device):
    x = torch.zeros((1, 4, 8), device=cuda_device, requires_grad=True)
    a = torch.zeros((8, 16), device=cuda_device)
    bc = torch.zeros((1, 4, 16), device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        mamba_scan(x, x, a, bc, bc)
    with torch.no_grad():
        assert mamba_scan(x, x, a, bc, bc).shape == x.shape


def test_ssm_forward_and_decode_on_card_match_cpu(cuda_device):
    """A reduced Falcon-Mamba on the card, fp32: the full forward (the scan
    kernel) and step-by-step decode against a CPU forward over the same
    weights."""
    from repro_torch.models import decode_step, forward, init_cache
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("falcon_mamba_7b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size,
                              compute_dtype="float32")
    params = init_params(0, cfg, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, 259, (2, 21)))
    n = mamba_scan.launches
    with torch.no_grad():
        got, _ = forward(params, cfg, {"tokens": toks.to(cuda_device)})
        want, _ = forward(_to_cpu(params), cfg, {"tokens": toks})
        cache = init_cache(cfg, 2, 21, device=cuda_device)
        steps = []
        for t in range(toks.shape[1]):
            lg, cache = decode_step(params, cfg, cache,
                                    toks[:, t].to(cuda_device),
                                    torch.full((2,), t, device=cuda_device))
            steps.append(lg)
    assert mamba_scan.launches == n + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(torch.stack(steps, 1).cpu(), want,
                               atol=1e-4, rtol=1e-4)


def _rglru_inputs(gen, B, S, W, a_max, device):
    """a = u^r with u in [0.9, a_max] (lambda's init) and r a sigmoid gate;
    b = sqrt(1 - a^2) i x, as the model hands them over."""
    u = 0.9 + (a_max - 0.9) * torch.rand(W, generator=gen, device=device)
    a = u ** torch.sigmoid(_randn(gen, (B, S, W), torch.float32, device))
    b = torch.sqrt(1 - a * a) * torch.sigmoid(
        _randn(gen, (B, S, W), torch.float32, device)) \
        * _randn(gen, (B, S, W), torch.float32, device)
    return a, b


@pytest.mark.parametrize("B,S,W", RGLRU_SHAPES)
def test_rglru_scan_kernel_matches_plain(cuda_device, B, S, W):
    """fp32 at the model's ranges, |err| <= 1e-4 + 1e-4 |ref| (the kernel
    rounds a*h + b once, the plain version twice); ragged S and W."""
    gen = torch.Generator(device=cuda_device).manual_seed(S + W)
    a, b = _rglru_inputs(gen, B, S, W, 0.999, cuda_device)
    n = rglru_scan.launches
    h = rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rglru_scan.launches == n + 1
    assert h.dtype == torch.float32 and h.shape == (B, S, W)
    _assert_close_rel(h, rglru_scan_ref(a, b), 1e-4)
    # bf16 inputs are cast to fp32, as the Pallas wrapper casts them
    _assert_close_rel(rglru_scan(a, b.bfloat16()),
                      rglru_scan_ref(a, b.bfloat16()), 1e-4)


@pytest.mark.parametrize("dist", ["model", "reference"])
def test_rglru_scan_kernel_is_as_close_to_fp64_as_plain(cuda_device, dist):
    """At the long prefill, against the recurrence in float64: the kernel's
    largest error is within twice the plain fp32 version's (plus 1e-6),
    with a up to 0.999, where a step's rounding is carried with a gain up
    to 1/(1-a), and with the reference test's a ~ U[0.4, 0.999], b
    normal."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    if dist == "model":
        a, b = _rglru_inputs(gen, 1, 2048, 4096, 0.999, cuda_device)
    else:
        a = 0.4 + 0.599 * torch.rand((1, 2048, 4096), generator=gen,
                                     device=cuda_device)
        b = _randn(gen, (1, 2048, 4096), torch.float32, cuda_device)
    truth = torch.empty_like(a, dtype=torch.float64)
    h = torch.zeros_like(a[:, 0], dtype=torch.float64)
    for t in range(a.shape[1]):
        h = a[:, t].double() * h + b[:, t].double()
        truth[:, t] = h
    with torch.no_grad():
        err_k = (rglru_scan(a, b).double() - truth).abs().max().item()
    err_p = (rglru_scan_ref(a, b).double() - truth).abs().max().item()
    assert err_k <= 2 * err_p + 1e-6, (err_k, err_p)


@pytest.mark.parametrize("B,S,W", [(4, 80, 4096), (1, 1, 5), (4, 128, 4096),
                                   (3, 77, 1000)])
@pytest.mark.parametrize("path", [1, 2])
def test_rglru_scan_forced_paths_match_plain(cuda_device, B, S, W, path):
    """Each path of the entry wherever both take S."""
    gen = torch.Generator(device=cuda_device).manual_seed(S + path)
    a, b = _rglru_inputs(gen, B, S, W, 0.999, cuda_device)
    with torch.no_grad():
        h = rglru_scan(a, b, path=path)
    _assert_close_rel(h, rglru_scan_ref(a, b), 1e-4)


@pytest.mark.parametrize("dist", ["model", "reference"])
def test_rglru_scan_short_path_is_as_close_to_fp64_as_plain(cuda_device,
                                                            dist):
    """At the trainers' 4 x 80 rows (the short path), as the long
    prefill's test holds the long path."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    if dist == "model":
        a, b = _rglru_inputs(gen, 4, 80, 4096, 0.999, cuda_device)
    else:
        a = 0.4 + 0.599 * torch.rand((4, 80, 4096), generator=gen,
                                     device=cuda_device)
        b = _randn(gen, (4, 80, 4096), torch.float32, cuda_device)
    truth = torch.empty_like(a, dtype=torch.float64)
    h = torch.zeros_like(a[:, 0], dtype=torch.float64)
    for t in range(a.shape[1]):
        h = a[:, t].double() * h + b[:, t].double()
        truth[:, t] = h
    with torch.no_grad():
        err_k = (rglru_scan(a, b).double() - truth).abs().max().item()
    err_p = (rglru_scan_ref(a, b).double() - truth).abs().max().item()
    assert err_k <= 2 * err_p + 1e-6, (err_k, err_p)


def test_rglru_scan_raises_under_grad_on_card(cuda_device):
    a = torch.zeros((1, 4, 8), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        rglru_scan(a, a)
    with torch.no_grad():
        assert rglru_scan(a, a).shape == a.shape


def test_hybrid_forward_and_decode_on_card_match_cpu(cuda_device):
    """A reduced RecurrentGemma on the card, fp32, 4 layers (a tile and a
    remainder layer) with an 8-key window over 21 tokens: the full forward
    (``rglru_scan`` and ``flash_attention``) and step-by-step decode over
    a ring that wraps (``decode_attention``, an fp32 cache) against a CPU
    forward over the same weights."""
    from repro_torch.models import decode_step, forward, init_cache
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("recurrentgemma_9b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size,
                              compute_dtype="float32", num_layers=4,
                              local_window=8)
    params = init_params(0, cfg, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, 259, (2, 21)))
    n = rglru_scan.launches, flash_attention.launches
    nd = decode_attention.launches
    with torch.no_grad():
        got, _ = forward(params, cfg, {"tokens": toks.to(cuda_device)})
        want, _ = forward(_to_cpu(params), cfg, {"tokens": toks})
        cache = init_cache(cfg, 2, 21, dtype=torch.float32,
                           device=cuda_device)
        steps = []
        for t in range(toks.shape[1]):
            lg, cache = decode_step(params, cfg, cache,
                                    toks[:, t].to(cuda_device),
                                    torch.full((2,), t, device=cuda_device))
            steps.append(lg)
    assert (rglru_scan.launches, flash_attention.launches) == (n[0] + 3,
                                                               n[1] + 1)
    assert decode_attention.launches == nd + 21
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(torch.stack(steps, 1).cpu(), want,
                               atol=1e-4, rtol=1e-4)


def _ppo_rows(n, L=20, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.r_[np.zeros(5), np.ones(L - 5)].astype(np.float32)
    return {"response": [rng.integers(3, 259, L) for _ in range(n)],
            "logprob": [np.full(L, -5.5, np.float32)] * n,
            "response_mask": [mask] * n,
            "advantage": [(rng.standard_normal(L) * mask).astype(np.float32)
                          for _ in range(n)],
            "returns": [(rng.standard_normal(L) * mask).astype(np.float32)
                        for _ in range(n)],
            "values": [(0.1 * rng.standard_normal(L)).astype(np.float32)
                       for _ in range(n)]}


def test_ppo_grads_on_card_match_cpu(cuda_device):
    """One PPO micro-batch of a reduced model, fp32 compute: the actor's
    gradients (plain attention route, fused-loss kernels with per-token
    advantages) and the critic's match the CPU's within 1e-4 relative; the
    critic's lm_head gradient is zero; its values through the flash kernel
    match the CPU's within 1e-4."""
    from repro_torch.autodiff import grad_and_metrics
    from repro_torch.engines import pack_rows
    from repro_torch.models import init_params
    from repro_torch.rl import ppo
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("qwen2_5_7b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size,
                              compute_dtype="float32")
    actor = init_params(0, cfg, device="cpu")
    critic = ppo.init_critic_params(torch.Generator().manual_seed(1), cfg)
    rows = _ppo_rows(4)
    rl = ppo.PPOConfig()
    for fn, params, zero_unused in ((ppo.ppo_actor_loss_fn, actor, False),
                                    (ppo.ppo_critic_loss_fn, critic, True)):
        n = fused_rl_loss_bwd.launches
        g_cpu, m_cpu = grad_and_metrics(fn, params, cfg,
                                        pack_rows(rows, 24, "cpu"), rl,
                                        zero_unused=zero_unused)
        g_gpu, m_gpu = grad_and_metrics(fn, _to(params, cuda_device), cfg,
                                        pack_rows(rows, 24, cuda_device), rl,
                                        zero_unused=zero_unused)
        assert fused_rl_loss_bwd.launches == n + (not zero_unused)
        for k in m_cpu:
            assert abs(float(m_gpu[k]) - float(m_cpu[k])) <= 1e-4 * (
                1 + abs(float(m_cpu[k])))
        for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)):
            assert float((a.cpu() - b).norm()
                         / b.norm().clamp_min(1e-30)) < 1e-4
    assert not g_gpu["backbone"]["lm_head"]["w"].any()
    toks = pack_rows(rows, 24, "cpu")["tokens"]
    n = flash_attention.launches
    with torch.no_grad():
        v_gpu = ppo.critic_forward(_to(critic, cuda_device), cfg,
                                   toks.to(cuda_device))
    assert flash_attention.launches == n + cfg.num_layers
    v_cpu = ppo.critic_forward(critic, cfg, toks, use_kernels=False)
    assert torch.allclose(v_gpu.cpu(), v_cpu, atol=1e-4, rtol=1e-4)


def test_checkpoint_round_trip_of_cuda_tensors(cuda_device, tmp_path):
    """A TrainState on the card goes to disk through the host and comes
    back on the card, bit for bit, with the ints as ints."""
    from repro_torch.models import init_params
    from repro_torch.training import (TrainState, restore_checkpoint,
                                      save_checkpoint)
    cfg = dataclasses.replace(get_config("qwen2_5_7b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size)
    state = TrainState.create(init_params(0, cfg, device=cuda_device))
    state.opt_state["count"] = 3
    state = state._replace(step=3)
    save_checkpoint(str(tmp_path / "ck"), state, step=3)
    like = TrainState.create(init_params(1, cfg, device=cuda_device))
    back, step = restore_checkpoint(str(tmp_path / "ck"), like)
    assert step == 3 and back.step == 3 and back.opt_state["count"] == 3
    from repro_torch.tree import tree_leaves
    for a, b in zip(tree_leaves(back.params), tree_leaves(state.params)):
        assert a.device.type == "cuda" and torch.equal(a, b)


def _grpo_microbatch(cfg, device, n=4, S=24):
    from repro_torch.engines import pack_rows
    rng = np.random.default_rng(0)
    rows = {"response": [rng.integers(3, cfg.vocab_size, S)
                         for _ in range(n)],
            "logprob": [np.full(S, -5.5, np.float32)] * n,
            "response_mask": [np.r_[np.zeros(5), np.ones(S - 5)]] * n,
            "advantage": [float(a) for a in rng.standard_normal(n)],
            "ref_logprob": [np.full(S, -5.4, np.float32)] * n}
    return pack_rows(rows, S, device)


def test_grpo_grads_on_card_are_bit_identical_across_calls(cuda_device):
    """Two gradient computations of one GRPO micro-batch from the same
    params, in bf16 compute through the kernels, agree byte for byte."""
    from repro_torch.models import init_params
    from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("qwen2_5_7b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size)
    params = init_params(0, cfg, device=cuda_device)
    batch = _grpo_microbatch(cfg, cuda_device)
    rl = GRPOConfig(kl_coef=0.05)
    g1, m1 = grpo_grad_step(params, cfg, rl, batch)
    g2, m2 = grpo_grad_step(params, cfg, rl, batch)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(g1), tree_leaves(g2)))


def test_embedding_gather_backward_on_card(cuda_device):
    """The gather's sorted backward on the card: equal ids' rows summed in
    a fixed order, bit-identical across calls, and within 1e-6 relative of
    autograd's own backward of the plain gather."""
    from repro_torch.models.layers import _Gather
    gen = torch.Generator(cuda_device).manual_seed(0)
    V, d = 152_064, 256
    table = torch.randn(V, d, generator=gen, device=cuda_device)
    tokens = torch.randint(0, 512, (16, 48), generator=gen,
                           device=cuda_device)
    up = torch.randn(16, 48, d, generator=gen, device=cuda_device)

    def grad(fn):
        t = table.detach().requires_grad_()
        return torch.autograd.grad(fn(t), t, up)[0]
    a, b = (grad(lambda t: _Gather.apply(t, tokens)) for _ in range(2))
    plain = grad(lambda t: t[tokens])
    assert torch.equal(a, b)
    assert float((a - plain).abs().max()) <= 1e-6 * float(plain.abs().max())


def test_engine_paged_rounds_on_card_equal_the_gather_rounds(cuda_device,
                                                            monkeypatch):
    """The reduced Qwen2.5 in bf16 through the continuous engine on the
    card: the decode rounds read the bf16 pool through the page table
    (the kernel's paged mode), and forced onto the gather route (per-slot
    views, the dense mode, the row scattered back) give the same tokens
    and logprobs bit for bit: ragged prompts, chunked continuations parked
    and resumed, one preemption (9 pages)."""
    from repro_torch.core.obs import MetricsRegistry
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.engines.continuous_batching import engine as cb
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("qwen2_5_7b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size)
    params = init_params(0, cfg, device=cuda_device)
    prompts = [[5, 6, 7], [8, 9, 10, 11, 12], [3, 4], [250, 251, 252, 253]]

    def run():
        eng = ContinuousBatchingEngine(
            cfg, num_slots=2, page_size=4, max_len=32, num_pages=9,
            max_new_tokens=8, eos_id=-1, seed=3, device=cuda_device,
            metrics=MetricsRegistry())
        items = [eng.make_sequence(p, chunk=3) for p in prompts]
        done = []
        n = decode_attention.launches
        while items:
            fin, paused = eng.generate(params, items)
            done += fin
            items = [eng.resume(q, chunk=3) for q in paused]
        assert decode_attention.launches > n
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


def _moe_cfg(top_k=None):
    cfg = dataclasses.replace(get_config("grok_1_314b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size,
                              compute_dtype="float32")
    return cfg if top_k is None else dataclasses.replace(cfg, top_k=top_k)


def test_moe_ffn_on_card_matches_cpu(cuda_device):
    """``moe_ffn`` of the reduced Grok on the card against the same call on
    the CPU, fp32: the same picks per expert (4 slots' worth of one-token
    rows, where half the picks drop, and a 2 x 40 block), the output and
    the aux loss within 1e-4; and in bf16 its input gradient
    bit-identical over two calls on the card."""
    from repro_torch.models import init_params
    from repro_torch.models import moe
    cfg = _moe_cfg()
    p = tree_map(lambda t: t[0],
                 init_params(0, cfg, device=cuda_device)["blocks"]["ffn"])
    p_cpu = tree_map(lambda t: t.cpu(), p)
    gen = torch.Generator(device="cpu").manual_seed(3)
    row = torch.randn((1, 1, cfg.d_model), generator=gen)
    for x in (row.expand(4, 1, cfg.d_model).contiguous(),
              torch.randn((2, 40, cfg.d_model), generator=gen)):
        y, aux = moe.moe_ffn(p, x.to(cuda_device), cfg)
        want, want_aux = moe.moe_ffn(p_cpu, x, cfg)
        st = moe.moe_router_stats(p, x.to(cuda_device), cfg)
        sc = moe.moe_router_stats(p_cpu, x, cfg)
        assert torch.equal(st.tokens_per_expert.cpu(), sc.tokens_per_expert)
        _assert_close_rel(y.cpu(), want, 1e-4)
        _assert_close_rel(aux.cpu(), want_aux, 1e-5)
    assert float(moe.moe_router_stats(
        p_cpu, row.expand(4, 1, cfg.d_model), cfg).dropped_fraction) == 0.5
    bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    xg = x.to(cuda_device, torch.bfloat16)

    def grad():
        xx = xg.detach().requires_grad_()
        out, a = moe.moe_ffn(p, xx, bf)
        return torch.autograd.grad(out.float().square().sum() + a, xx)[0]
    assert torch.equal(grad(), grad())


def test_moe_engine_on_card_matches_cpu_forward(cuda_device):
    """The continuous engine serving the reduced Grok on the card (both
    attention kernels run), scored by a CPU forward, fp32. Every token is
    routed to every expert, so no pick drops and the batched decode must
    equal the forward."""
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.models import forward, init_params
    cfg = _moe_cfg(top_k=4)
    params = init_params(0, cfg, device=cuda_device)
    eng = ContinuousBatchingEngine(cfg, num_slots=2, max_len=64,
                                   max_new_tokens=6, eos_id=-1,
                                   dtype=torch.float32, device=cuda_device)
    rng = np.random.default_rng(0)
    seqs = [eng.make_sequence(rng.integers(3, 259, n)) for n in (5, 17, 9)]
    n_d, n_f = decode_attention.launches, flash_attention.launches
    fin, _ = eng.generate(params, seqs)
    assert decode_attention.launches > n_d and flash_attention.launches > n_f
    cpu = _to_cpu(params)
    for q in fin:
        with torch.no_grad():
            logits, _ = forward(cpu, cfg, {"tokens": torch.tensor(q.tokens)[
                None]})
        logp = torch.log_softmax(logits[0].float(), dim=-1)
        want = [logp[t - 1, q.tokens[t]].item()
                for t in range(q.prompt_len, len(q.tokens))]
        np.testing.assert_allclose(q.logprobs[q.prompt_len:], want,
                                   atol=1e-4, rtol=1e-4)


def test_vlm_forward_on_card_matches_cpu(cuda_device):
    """The reduced InternVL2's forward with ``vision_embeds`` through the
    flash kernel on the card against the CPU's plain run, fp32."""
    from repro_torch.models import forward, init_params
    cfg = dataclasses.replace(get_config("internvl2_26b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size,
                              compute_dtype="float32")
    params = init_params(0, cfg, device=cuda_device)
    gen = torch.Generator(device="cpu").manual_seed(4)
    batch = {"tokens": torch.randint(3, 259, (2, 12), generator=gen),
             "vision_embeds": torch.randn(2, cfg.vision_tokens, cfg.d_model,
                                          generator=gen)}
    n = flash_attention.launches
    with torch.no_grad():
        got, _ = forward(params, cfg, tree_map(lambda t: t.to(cuda_device),
                                               batch))
        want, _ = forward(_to_cpu(params), cfg, batch)
    assert flash_attention.launches == n + cfg.num_layers
    _assert_close_rel(got.cpu(), want, 1e-4)


def test_moe_grads_on_card_are_bit_identical_across_calls(cuda_device):
    """Two GRPO gradient computations of the reduced Grok (4 rows of 24
    tokens, top 2 of 4 experts) in bf16 through the kernels agree byte for
    byte."""
    from repro_torch.models import init_params
    from repro_torch.rl.grpo import GRPOConfig, grpo_grad_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(_moe_cfg(), compute_dtype="bfloat16")
    params = init_params(0, cfg, device=cuda_device)
    batch = _grpo_microbatch(cfg, cuda_device)
    rl = GRPOConfig(kl_coef=0.05)
    g1, m1 = grpo_grad_step(params, cfg, rl, batch)
    g2, m2 = grpo_grad_step(params, cfg, rl, batch)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(g1), tree_leaves(g2)))


@pytest.mark.parametrize("arch", ["minicpm3_4b", "deepseek_v2_236b"])
def test_mla_decode_on_card_equals_naive_forward(cuda_device, arch):
    """The reduced MiniCPM3 and DeepSeek-V2 with q_lora (DeepSeek routing
    every token to every expert, where nothing drops) on the card, fp32:
    the absorbed decode over an fp32 latent cache against the naive
    forward over the same tokens, teacher-forced, within 1e-4; the
    forward against the CPU's; no attention kernel launches (MLA has
    none)."""
    from repro_torch.models import decode_step, forward, init_cache, \
        init_params
    cfg = dataclasses.replace(get_config(arch).reduced(), q_lora_rank=48,
                              vocab_size=ByteTokenizer.vocab_size,
                              compute_dtype="float32")
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, top_k=cfg.num_experts)
    params = init_params(0, cfg, device=cuda_device)
    B, T = 2, 12
    toks = torch.randint(3, 259, (B, T),
                         generator=torch.Generator().manual_seed(5))
    n = flash_attention.launches, decode_attention.launches
    with torch.no_grad():
        want, _ = forward(params, cfg, {"tokens": toks.to(cuda_device)})
        cpu, _ = forward(_to_cpu(params), cfg, {"tokens": toks})
        cache = init_cache(cfg, B, T, dtype=torch.float32,
                           device=cuda_device)
        for t in range(T):
            got, cache = decode_step(params, cfg, cache,
                                     toks[:, t].to(cuda_device),
                                     torch.full((B,), t, device=cuda_device))
            _assert_close_rel(got.cpu(), want[:, t].cpu(), 1e-4)
    _assert_close_rel(want.cpu(), cpu, 1e-4)
    assert (flash_attention.launches, decode_attention.launches) == n


@pytest.mark.parametrize("cache", ["cross", "self"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_at_whisper_group_1(cuda_device, cache, dtype):
    """Whisper-tiny's decode: 6 query heads on 6 KV heads (a group of 1)
    at hd 64, over the 1500-key cross cache, every key valid (a ragged
    tail for every tile), and over a 64-key self cache filled to ragged
    prefixes (row 0: one key)."""
    B, H, hd = 4, 6, 64
    S = 1500 if cache == "cross" else 64
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    q = _randn(gen, (B, 1, H, hd), dtype, cuda_device)
    k = _randn(gen, (B, S, H, hd), dtype, cuda_device)
    v = _randn(gen, (B, S, H, hd), dtype, cuda_device)
    fill = np.full(B, S) if cache == "cross" else np.array([1, 17, 40, 64])
    valid = torch.from_numpy(np.arange(S)[None, :] < fill[:, None]).to(
        cuda_device)
    n = decode_attention.launches
    out = decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(),
                               decode_attention_ref(q, k, v, valid).float(),
                               atol=tol, rtol=tol)


def test_whisper_forward_and_decode_on_card_match_cpu(cuda_device):
    """A reduced Whisper on the card, fp32: the forward (flash for the
    decoder's self-attention) against the CPU's, then the cross cache and
    step-by-step decode (both caches through the decode kernel) against
    that forward, teacher-forced."""
    from repro_torch.models import decode_step, encdec, forward, init_cache
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("whisper_tiny").reduced(),
                              vocab_size=ByteTokenizer.vocab_size,
                              compute_dtype="float32")
    params = init_params(0, cfg, device=cuda_device)
    B, T = 2, 12
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(3, 259, (B, T), generator=gen)
    frames = torch.randn((B, cfg.encoder_frames, cfg.d_model),
                         generator=gen)
    n = flash_attention.launches, decode_attention.launches
    with torch.no_grad():
        want, _ = forward(params, cfg, {"tokens": toks.to(cuda_device),
                                        "frames": frames.to(cuda_device)})
        cpu, _ = forward(_to_cpu(params), cfg, {"tokens": toks,
                                                "frames": frames})
        cache = init_cache(cfg, B, T, dtype=torch.float32,
                           device=cuda_device)
        encdec.precompute_cross_kv(
            params, cfg, encdec.encode(params, cfg, frames.to(cuda_device)),
            cache)
        for t in range(T):
            got, cache = decode_step(params, cfg, cache,
                                     toks[:, t].to(cuda_device),
                                     torch.full((B,), t, device=cuda_device))
            _assert_close_rel(got.cpu(), want[:, t].cpu(), 1e-4)
    _assert_close_rel(want.cpu(), cpu, 1e-4)
    assert flash_attention.launches == n[0] + cfg.num_layers
    assert decode_attention.launches == n[1] + 2 * cfg.num_layers * T


@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_decode_on_a_one_rank_nccl_group(cuda_device, dtype):
    """``sharded_decode_attention`` on the card's 1 x 1 mesh (a one-rank
    NCCL group over a ``HashStore``) at the Qwen decode shape, against the
    plain decode; the mesh route launches no ``decode_attention``."""
    import torch.distributed as dist

    from repro_torch.distributed import sharded_decode_attention
    from repro_torch.launch.mesh import make_debug_mesh
    B, S, H, KV, hd = 4, 2080, 28, 4, 128
    gen = torch.Generator(device=cuda_device).manual_seed(2080)
    q = _randn(gen, (B, 1, H, hd), dtype, cuda_device)
    k = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    v = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    valid = torch.from_numpy(np.arange(S)[None, :] < np.array(
        [1, 700, 1500, 2080])[:, None]).to(cuda_device)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        n = decode_attention.launches
        out = sharded_decode_attention(q, k, v, valid, mesh=mesh)
        torch.cuda.synchronize()
        assert decode_attention.launches == n
    finally:
        dist.destroy_process_group()
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(),
                               decode_attention_ref(q, k, v, valid).float(),
                               atol=tol, rtol=tol)


# -- DeepSeek-V2 on the continuous engine -------------------------------------

def _ds_v2(**changes):
    """The benchmark's DeepSeek-V2 share (``perfbench/configs/
    deepseek_v2_ep8.json``'s ``port``) with ``changes``."""
    import json
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "perfbench" / "configs" \
        / "deepseek_v2_ep8.json"
    return dict(json.loads(path.read_text())["port"], **changes)


def test_paged_latent_decode_on_card_matches_the_dense_cache(cuda_device):
    """One DeepSeek-V2 attention layer at the rollout cell's shape (512
    slots filled to 1-2304 keys, 128 heads, latent 512 + 64, bf16, pages
    of 8 shuffled over the pool): ``mla_decode`` through the page table
    against the same rows in a dense latent cache. bf16: the gathered
    rows are the dense ones, but the products may take other kernels on
    strided operands, so one bf16 rounding of the output apart."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import mla
    cfg = ModelConfig(**_ds_v2(num_layers=1))
    gen = torch.Generator(device=cuda_device).manual_seed(2304)
    p = tree_map(lambda t: t[0], mla.init_mla(gen, cfg, layers=(1,)))
    p["kv_norm"] = {"scale": 1 + 0.02 * torch.randn(
        cfg.kv_lora_rank, generator=gen, device=cuda_device)}
    p["q_norm"] = {"scale": 1 + 0.02 * torch.randn(
        cfg.q_lora_rank, generator=gen, device=cuda_device)}
    B, S, ps = 512, 2304, 8
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    bf = torch.bfloat16
    dense = {"c_kv": _randn(gen, (B, S, r), bf, cuda_device),
             "k_rope": _randn(gen, (B, S, dr), bf, cuda_device)}
    pages = B * S // ps
    table = (torch.randperm(pages, generator=gen, device=cuda_device)
             .view(B, S // ps) + 1)
    pool = torch.zeros((1 + pages, ps, r + dr), dtype=bf, device=cuda_device)
    pool[table.reshape(-1)] = torch.cat(
        [dense["c_kv"], dense["k_rope"]], -1).view(-1, ps, r + dr)
    pos = torch.randint(0, S, (B,), generator=gen, device=cuda_device)
    pos[:2] = torch.tensor([0, S - 1])
    x = _randn(gen, (B, 1, cfg.d_model), bf, cuda_device)
    with torch.no_grad():
        want, _ = mla.mla_decode(p, x, dense, pos, cfg)
        got, _ = mla.mla_decode(p, x, mla.paged_latent_cache(pool, table,
                                                             pos), pos, cfg)
    _assert_close_rel(got.float(), want.float(), 2e-2)
    back = pool[table].reshape(B, S, r + dr)
    assert torch.equal(back[..., :r], dense["c_kv"])


def test_grouped_expert_ffn_on_card_matches_its_loop(cuda_device):
    """The held experts' grouped products (``torch._grouped_mm`` over
    device counts) at the cell's decode shape (512 tokens x 6 picks, 20
    held experts of 5120 x 1536, bf16) against the per-expert loop, the
    rows past the held picks left out: within one bf16 rounding (the
    products' order in fp32 accumulators differs)."""
    from repro_torch.models import moe
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    E, d, dff = 20, 5120, 1536
    ex = {n: 0.02 * torch.randn(s, generator=gen, device=cuda_device)
          for n, s in (("up", (E, d, dff)), ("gate", (E, d, dff)),
                       ("down", (E, dff, d)))}
    xs = _randn(gen, (3072, d), torch.bfloat16, cuda_device)
    for held in (0, 1, 384, 3072):
        ids = torch.randint(0, E, (held,), generator=gen, device=cuda_device)
        counts = torch.zeros(E, dtype=torch.int64, device=cuda_device) \
            .scatter_add(0, ids, torch.ones_like(ids))
        got = moe.grouped_expert_ffn(ex, xs, counts, "silu", torch.bfloat16)
        w = tree_map(lambda t: t.bfloat16(), ex)
        lo = 0
        for e, hi in enumerate(torch.cumsum(counts, 0).tolist()):
            a = xs[lo:hi]
            want = (a @ w["up"][e]) * torch.nn.functional.silu(
                a @ w["gate"][e]) @ w["down"][e]
            if hi > lo:
                _assert_close_rel(got[lo:hi].float(), want.float(), 2e-2)
            lo = hi


def test_deepseek_v2_engine_on_card_matches_the_reference(cuda_device):
    """DeepSeek-V2 at its published widths, 1 dense + 4 MoE layers (20 of
    160 experts held), through the continuous engine on the card in fp32
    (4 slots, pages of 8, 6 ragged requests; the experts' loop route and
    the fp32 latent pool), each served logprob against the benchmark's
    plain reference in fp32: float32 round-off through 5 layers of
    128-head latent attention, 1e-3."""
    from perfbench.core.weights import make
    from perfbench.reference import moe as ref
    from perfbench.reference.precision import Precision
    from repro_torch.configs.base import ModelConfig
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine

    class F32(Precision):
        def __init__(self):
            self.name, self.act = "f32", torch.float32

        def mm(self, x, w):
            return torch.matmul(x.float(), w.float())

    c = _ds_v2(num_layers=5, compute_dtype="float32")
    params = make(ref.layout(c), 2**33 + 17, cuda_device)
    eng = ContinuousBatchingEngine(
        ModelConfig(**c), num_slots=4, page_size=8, max_len=96,
        max_new_tokens=8, eos_id=-1, seed=11, dtype=torch.float32,
        device=cuda_device)
    rng = np.random.default_rng(17)
    fin, _ = eng.generate(params, [
        eng.make_sequence(rng.integers(0, c["vocab_size"], n).tolist(),
                          max_new=m)
        for n, m in ((9, 8), (40, 3), (17, 6), (64, 8), (5, 5), (30, 7))])
    assert len(fin) == 6
    for q in fin:
        toks = torch.tensor(q.tokens, device=cuda_device)[None]
        with torch.no_grad():
            lp = torch.log_softmax(ref.forward(params, toks, c, F32())[0],
                                   -1)
        want = lp[torch.arange(q.prompt_len - 1, len(q.tokens) - 1),
                  toks[0, q.prompt_len:]].cpu()
        got = torch.tensor(q.logprobs[q.prompt_len:])
        assert float((got - want).abs().max()) <= 1e-3
