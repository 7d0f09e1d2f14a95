"""The frozen FLOP and byte counts against counts made by hand."""
import pytest

from perfbench.core import flops

DENSE = dict(arch_type="dense", num_layers=2, d_model=8, num_heads=4,
             num_kv_heads=2, head_dim=2, d_ff=16, vocab_size=10,
             activation="silu")
SSM = dict(arch_type="ssm", num_layers=3, d_model=8, ssm_expand=2,
           ssm_state=4, ssm_conv=4, ssm_dt_rank=2, vocab_size=10)


def test_dense_layer_by_hand():
    # q 8x8, k 8x4, v 8x4, o 8x8, gate/up 8x16, down 16x8: 2 FLOPs a MAC
    macs = 64 + 32 + 32 + 64 + 3 * 128
    assert flops.layer_flops_per_token(DENSE) == 2 * macs


def test_ssm_layer_by_hand():
    # in 8x32, x_proj 16x(2+8), dt 2x16, out 16x8; scan 6 per state
    macs = 8 * 32 + 16 * 10 + 2 * 16 + 16 * 8
    assert flops.layer_flops_per_token(SSM) == 2 * macs + 6 * 16 * 4


@pytest.mark.parametrize("n,start,want", [(1, 0, 1), (3, 0, 6),
                                          (4, 2, 7)])
def test_causal_keys(n, start, want):
    assert flops.causal_keys(n, start) == want


def test_forward_by_hand():
    tokens, keys, logits = 3, 6, 2
    want = (3 * 2 * flops.layer_flops_per_token(DENSE)
            + 4 * 6 * 4 * 2 * 2          # 4 FLOPs x keys x H x hd x L
            + 2 * 2 * 8 * 10)
    assert flops.forward_flops(DENSE, tokens, keys, logits) == want
    assert flops.attention_flops(SSM, 100) == 0.0


def test_grpo_sample_is_five_forwards():
    one = flops.forward_flops(DENSE, 7, flops.causal_keys(7), 3)
    assert flops.grpo_sample_flops(DENSE, 4, 3) == 5 * one


def test_kernel_bytes_by_hand():
    N, V = 3, 5
    assert flops.fused_rl_loss_fwd(N, V, 2) == (30 + 60 + 72, 0.0)
    assert flops.fused_rl_loss_bwd(N, V, 2) == (60 + 72, 0.0)
    nb, fl = flops.decode_attention(B=2, S=8, H=4, KVH=2, hd=2, keys=5,
                                    elem=2)
    assert nb == 2 * 2 * 4 * 2 * 2 + 2 * 5 * 2 * 2 * 2 + 16
    assert fl == 4 * 5 * 4 * 2


def test_least_time_takes_the_larger_bound():
    assert flops.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert flops.least_seconds(0, 989e12 * 2) == pytest.approx(2.0)
