"""The port on the card: each CUDA kernel against its plain PyTorch version,
and the serving engine on CUDA against a CPU forward. Every test takes the
``cuda_device`` fixture and skips where there is no card. The file imports
neither JAX nor the reference, so on a machine with a card and no JAX it
runs alone: ``PYTHONPATH=src python -m pytest --noconftest
tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)

# fp32: summation order differs on the card; bf16: one rounding of the output
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 4, 4, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 32),
    (2, 128, 4, 4, 128), (2, 100, 4, 2, 64), (4, 1000, 28, 4, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 64])
def test_flash_kernel_matches_plain(cuda_device, B, S, H, KV, hd, dtype,
                                    window):
    gen = torch.Generator(device=cuda_device).manual_seed(S + hd)
    q = _randn(gen, (B, S, H, hd), dtype, cuda_device)
    k = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    v = _randn(gen, (B, S, KV, hd), dtype, cuda_device)
    n = flash_attention.launches
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    ref = flash_attention_ref(q, k, v, window=window)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 1024, 4, 2, 64), (1, 2048, 8, 8, 32), (3, 512, 4, 1, 128),
    (3, 100, 4, 2, 64), (4, 4099, 28, 4, 128), (2, 5, 16, 1, 64)])
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
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def test_engine_on_card_matches_cpu_forward(cuda_device):
    """Serve a reduced model on the card (both kernels run), then score the
    sampled tokens with a CPU forward over the same weights (fp32)."""
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.models import forward, init_params

    cfg = dataclasses.replace(get_config("qwen2_5_7b").reduced(),
                              vocab_size=ByteTokenizer.vocab_size,
                              compute_dtype="float32")
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
