"""The port's attention kernels against the reference's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; that version is
held against the JAX kernel in interpret mode on the same inputs (made
with numpy), at the shapes of ``tests/test_kernels.py`` plus a ragged
S=100. ``tests/test_torch_cuda.py`` holds the CUDA kernels against the
plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import \
    decode_attention_kernel
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_kernel
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(out_t, out_j, tol):
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32),
                               atol=tol, rtol=tol)


def _valid(rng, B, S, empty_row=False):
    fill = rng.integers(1, S + 1, size=B)
    if empty_row:
        fill[0] = 0                    # no valid key: uniform average
    return np.arange(S)[None, :] < fill[:, None]


FLASH_SHAPES = [
    (1, 128, 4, 4, 64),       # MHA
    (2, 256, 4, 2, 64),       # GQA 2:1
    (1, 256, 8, 1, 32),       # MQA
    (2, 128, 4, 4, 128),      # 128-wide heads
    (2, 100, 4, 2, 64),       # ragged S
    (1, 128, 8, 2, 160),      # StableLM-2-12B's hd 160, its group of 4
    (2, 100, 4, 1, 160),      # hd 160, ragged S
]


@pytest.mark.parametrize("B,S,H,KV,hd", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("window", [0, 64])
def test_flash_plain_matches_jax_kernel(B, S, H, KV, hd, dtype, window):
    rng = np.random.default_rng(S * 31 + H)
    x = [rng.standard_normal(s).astype(np.float32)
         for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in x)
    ref = flash_attention_kernel(qj, kj, vj, window=window,
                                 block_q=min(128, S), block_k=min(128, S),
                                 interpret=True)
    out = flash_attention(qt, kt, vt, window=window)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, ref, DTYPES[dtype][2])


def _bf16_kernel_numerics(q, k, v, window, block_k):
    """What the CUDA kernel computes for bf16 inputs, on the CPU: fp32
    scores, an online softmax in base 2 over key tiles of ``block_k``, the
    row sum of the fp32 P, and P rounded to bf16 before P V (the one
    departure from the reference, whose P stays fp32)."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(H // KVH, dim=2)
    v = v.float().repeat_interleave(H // KVH, dim=2)
    qf = q.float()
    scale_log2 = hd ** -0.5 * 1.4426950408889634
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, hd))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, block_k):
        kt, vt = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * scale_log2
        kpos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("B,S,H,KV,hd,window,block_k", [
    (1, 128, 4, 4, 64, 0, 128),      # MHA, one tile
    (2, 256, 7, 1, 128, 0, 128),     # Qwen2.5's group of 7, two tiles
    (1, 256, 8, 2, 32, 64, 128),     # GQA 4:1 with a window
    (2, 100, 4, 2, 64, 32, 128),     # ragged S with a window
    (1, 96, 16, 1, 256, 32, 32),     # RecurrentGemma's hd 256, 32-key tiles
    (1, 128, 8, 2, 160, 0, 64),      # hd 160 (run at 192), 64-key tiles
])
def test_bf16_kernel_numerics_within_the_reference_bar(B, S, H, KV, hd,
                                                       window, block_k):
    """The bf16 kernel's departure (P rounded to bf16 before P V) held
    against the reference's Pallas kernel in interpret mode, on the same
    bf16 inputs, within the bf16 bar 2e-2 + 2e-2 |ref|: where no card is
    present this shows the departure stays inside the reference's own
    bar."""
    rng = np.random.default_rng(S * 13 + hd)
    x = [rng.standard_normal(s).astype(np.float32)
         for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in x)
    ref = flash_attention_kernel(qj, kj, vj, window=window,
                                 block_q=min(128, S), block_k=min(128, S),
                                 interpret=True)
    out = _bf16_kernel_numerics(qt, kt, vt, window, block_k)
    assert out.dtype == torch.bfloat16 and out.shape == qt.shape
    _close(out, ref, 2e-2)


DECODE_SHAPES = [
    (2, 1024, 4, 2, 64),
    (1, 2048, 8, 8, 32),
    (3, 512, 4, 1, 128),
    (3, 100, 4, 2, 64),       # ragged S, one row with no valid key
    (2, 300, 8, 2, 160),      # StableLM-2-12B's hd 160, its group of 4
    (3, 100, 32, 8, 160),     # its heads, ragged S, a row with no key
]


@pytest.mark.parametrize("B,S,H,KV,hd", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_plain_matches_jax_kernel(B, S, H, KV, hd, dtype):
    rng = np.random.default_rng(S * 17 + H)
    x = [rng.standard_normal(s).astype(np.float32)
         for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in x)
    valid = _valid(rng, B, S, empty_row=S == 100)
    ref = decode_attention_kernel(qj, kj, vj, jnp.asarray(valid),
                                  block_k=min(512, S), interpret=True)
    out = decode_attention(qt, kt, vt, torch.from_numpy(valid))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, ref, DTYPES[dtype][2])


def _page_table(rng, B, P, ps, fill):
    """Each row's pages as the continuous engine lays them: distinct
    shuffled ids for the pages its ``fill`` keys need, the reserved page 0
    past them. Returns (table (B, P) int64, pages in the pool)."""
    need = -(-fill // ps)
    ids = rng.permutation(np.arange(1, 1 + need.sum()))
    table = np.zeros((B, P), np.int64)
    for b, row in enumerate(np.split(ids, np.cumsum(need)[:-1])):
        table[b, :len(row)] = row
    return table, 1 + int(need.sum())


@pytest.mark.parametrize("B,S,H,KV,hd,ps", [
    (3, 96, 4, 2, 64, 8), (2, 160, 7, 1, 128, 16), (3, 100, 32, 8, 160, 4)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_decode_plain_matches_jax_kernel_on_the_pages(B, S, H, KV, hd,
                                                            ps, dtype):
    """On the CPU the paged entry gathers each row's pages through its
    table and runs the plain version: bit for bit ``decode_attention``
    on the gathered views, within the bar of the reference's kernel on
    them, and no launch counted."""
    rng = np.random.default_rng(S * 19 + hd)
    fill = rng.integers(1, S + 1, size=B)
    table, NP = _page_table(rng, B, S // ps, ps, fill)
    x = [rng.standard_normal(s).astype(np.float32)
         for s in ((B, 1, H, hd), (NP, ps, KV, hd), (NP, ps, KV, hd))]
    q, k_pool, v_pool = (_pair(a, dtype)[1] for a in x)
    k, v = (a[table].reshape(B, S, KV, hd) for a in x[1:])
    valid = np.arange(S)[None, :] < fill[:, None]
    n = decode_attention.launches
    out = paged_decode_attention(q, k_pool, v_pool, torch.from_numpy(table),
                                 torch.from_numpy(valid))
    assert decode_attention.launches == n
    (kj, kt), (vj, vt) = _pair(k, dtype), _pair(v, dtype)
    assert torch.equal(out, decode_attention(q, kt, vt,
                                             torch.from_numpy(valid)))
    ref = decode_attention_kernel(_pair(x[0], dtype)[0], kj, vj,
                                  jnp.asarray(valid), block_k=min(512, S),
                                  interpret=True)
    _close(out, ref, DTYPES[dtype][2])


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, 32), np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 16, 2, 32), np.float32))
    valid = torch.ones((1, 16), dtype=torch.bool)
    n_f, n_d = flash_attention.launches, decode_attention.launches
    assert torch.equal(flash_attention(q, kv, kv, window=4),
                       flash_attention_ref(q, kv, kv, window=4))
    assert torch.equal(decode_attention(q[:, :1], kv, kv, valid),
                       decode_attention_ref(q[:, :1], kv, kv, valid))
    assert (flash_attention.launches, decode_attention.launches) == \
        (n_f, n_d)


@pytest.mark.parametrize("B,S,H,KVH", [(4, 2080, 28, 4), (4, 4099, 28, 4),
                                       (1, 1, 4, 4), (3, 100, 4, 1),
                                       (64, 8, 28, 4), (1, 524288, 32, 8),
                                       (2, 777, 64, 2)])
def test_decode_splits_cover_s_with_no_empty_split(B, S, H, KVH):
    """The S splits the wrapper hands the CUDA entry: at most one cluster
    of MAX_SPLITS blocks per (batch, KV head, group of 16 heads), cut at
    whole tiles, every split holding at least one key, together covering
    S, and each as short as keeping the blocks within two per SM allows
    (the entry refuses anything else)."""
    from repro_torch.kernels.decode_attention import ops
    n_sm = 132
    nsplit, chunk = ops._splits(n_sm, B, S, H, KVH)
    assert 1 <= nsplit <= ops.MAX_SPLITS and chunk % ops.TILE == 0
    assert (nsplit - 1) * chunk < S <= nsplit * chunk
    blocks = B * KVH * -(-(H // KVH) // ops.GROUP)
    assert nsplit == 1 or blocks * nsplit <= 2 * n_sm
    # no block takes a tile more than the split bound forces
    most = max(1, min(ops.MAX_SPLITS, 2 * n_sm // blocks))
    assert chunk == ops.TILE or (chunk - ops.TILE) * most < S


def _bf16_decode_numerics(q, k, v, valid, keys=16):
    """What the CUDA kernel computes for bf16 inputs, on the CPU: each
    warp's 16 keys an online-softmax state in base 2 (masked keys weigh 0
    from the mask), P rounded to bf16 before P V, the states merged at
    the end; a row with no valid key the uniform average of V."""
    B, _, H, hd = q.shape
    S, KVH = k.shape[1], k.shape[2]
    k = k.float().repeat_interleave(H // KVH, dim=2)
    v = v.float().repeat_interleave(H // KVH, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), k) \
        * hd ** -0.5 * 1.4426950408889634
    ok = valid[:, None, :].expand(B, H, S)
    pad = -S % keys
    s = torch.nn.functional.pad(s, (0, pad)).reshape(B, H, -1, keys)
    ok = torch.nn.functional.pad(ok, (0, pad)).reshape(B, H, -1, keys)
    vv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(
        B, -1, keys, H, hd)
    m = torch.where(ok, s, torch.tensor(-1e30)).amax(-1)      # per state
    p = torch.where(ok, torch.exp2(s - m[..., None]), torch.tensor(0.0))
    l = p.sum(-1)
    o = torch.einsum("bhck,bckhd->bhcd", p.bfloat16().float(), vv)
    mx = m.amax(-1, keepdim=True)
    f = torch.exp2(m - mx)
    out = (o * f[..., None]).sum(2) / (l * f).sum(-1).clamp_min(1e-30)[
        ..., None]
    empty = ~valid.any(-1)
    out[empty] = v[empty].mean(1)
    return out[:, None].to(q.dtype)


@pytest.mark.parametrize("B,S,H,KV,hd", DECODE_SHAPES)
def test_bf16_decode_numerics_within_the_reference_bar(B, S, H, KV, hd):
    """The bf16 decode kernel's departure (P rounded to bf16 before P V,
    per 16-key state) held against the reference's Pallas kernel in
    interpret mode on the same bf16 inputs and masks with holes, within
    the bf16 bar 2e-2 + 2e-2 |ref|."""
    rng = np.random.default_rng(S * 19 + hd)
    x = [rng.standard_normal(s).astype(np.float32)
         for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in x)
    valid = rng.random((B, S)) < 0.4
    valid[-1] = False                  # no valid key: uniform average
    ref = decode_attention_kernel(qj, kj, vj, jnp.asarray(valid),
                                  block_k=min(512, S), interpret=True)
    out = _bf16_decode_numerics(qt, kt, vt, torch.from_numpy(valid))
    assert out.dtype == torch.bfloat16 and out.shape == qt.shape
    _close(out, ref, 2e-2)
