"""The traffic generator: deterministic in the seed, the same work for
every seed, prompts the program can take, the reward rule by hand."""
import numpy as np
import pytest

from perfbench.core import traffic
from perfbench.core.spec import PB, read_json

SEEDS = [0, 7, 2**31 + 5, 2**33 + 17]


@pytest.mark.parametrize("mix_name,block", [("grpo_math", 8),
                                            ("rollout_groups", 32)])
def test_blocks_are_deterministic_in_the_seed(mix_name, block):
    mix = read_json(PB / "traffic" / f"{mix_name}.json")
    for seed in SEEDS:
        a = traffic.Prompts(mix, seed, 152064, block).make_block(3)
        b = traffic.Prompts(mix, seed, 152064, block).make_block(3)
        assert all(np.array_equal(x["tokens"], y["tokens"])
                   and x["answer"] == y["answer"] for x, y in zip(a, b))
    other = traffic.Prompts(mix, SEEDS[0] + 1, 152064, block).make_block(3)
    assert not np.array_equal(a[0]["tokens"], other[0]["tokens"])


@pytest.mark.parametrize("mix_name,block,vocab", [
    ("grpo_math", 8, 152064), ("grpo_math", 8, 65024),
    ("rollout_groups", 32, 152064)])
def test_every_seed_gets_the_same_lengths(mix_name, block, vocab):
    mix = read_json(PB / "traffic" / f"{mix_name}.json")
    want = sorted(traffic.block_lengths(mix["prompt_len"], block))
    lo, hi = mix["prompt_len"]["min"], mix["prompt_len"]["max"]
    assert lo <= want[0] and want[-1] <= hi
    for seed in SEEDS:
        for b in (0, 5):
            ps = traffic.Prompts(mix, seed, vocab, block).make_block(b)
            assert sorted(len(p["tokens"]) for p in ps) == want
            for p in ps:
                t = p["tokens"]
                assert t[0] == traffic.BOS and t.max() < vocab
                assert t.min() >= 1
                tail = bytes(int(x) - traffic.BYTE_BASE
                             for x in t[-len(p["text"]):]).decode()
                a, c = tail.rstrip("=").split("+")
                assert int(a) + int(c) == p["answer"] and tail == p["text"]


def test_block_lengths_are_quantiles():
    assert traffic.block_lengths({"dist": "uniform", "min": 0, "max": 8},
                                 4) == [1, 3, 5, 7]
    got = traffic.block_lengths({"dist": "loguniform", "min": 1,
                                 "max": 16}, 2)
    assert got == [2, 8]
    # lognormal of mean 100, sigma 0.6: the median is 100 exp(-0.18)
    ln = {"dist": "lognormal", "mean": 100, "sigma": 0.6, "min": 1,
          "max": 150}
    assert traffic.block_lengths(ln, 1) == [84]
    got = traffic.block_lengths(ln, 1000)
    assert got == sorted(got) and got[-1] == 150 and got[0] >= 1
    assert 85 < np.mean(got) < 100           # the cap trims the tail


def test_every_seed_gets_the_same_response_lengths():
    mix = read_json(PB / "traffic" / "rollout_groups.json")
    G, block = mix["group_size"], mix["block"]
    want = sorted(traffic.block_lengths(mix["response_len"], block * G))
    assert want[-1] <= traffic.max_new(mix)
    assert mix["prompt_len"]["max"] + traffic.max_new(mix) <= \
        mix["engine"]["max_len"]
    firsts = set()
    for seed in SEEDS:
        ps = traffic.Prompts(mix, seed, 152064, block).make_block(2)
        got = [n for p in ps for n in p["new_tokens"]]
        assert all(len(p["new_tokens"]) == G for p in ps)
        assert sorted(got) == want
        firsts.add(tuple(got[:G]))
    assert len(firsts) == len(SEEDS)
    assert "new_tokens" not in traffic.Prompts(
        read_json(PB / "traffic" / "grpo_math.json"), 0, 152064,
        8).make_block(0)[0]


def test_residue_reward_by_hand():
    rule = {"kind": "residue", "modulus": 8}
    assert traffic.reward(rule, 11, [3, 11, 19, 4]) == 0.75
    assert traffic.reward(rule, 11, []) == 0.0
    assert traffic.reward(rule, 0, [8, 16, 1, 2]) == 0.5


def test_group_advantages_by_hand():
    a = traffic.group_advantages([0.0, 1.0, 0.0, 1.0])
    assert np.allclose(a, [-1, 1, -1, 1], atol=1e-5)
    assert np.allclose(traffic.group_advantages([2.0, 2.0]), 0.0)


def test_stream_seed_takes_any_integer():
    s = {traffic.stream_seed(x, "w", 1) for x in (0, 1, 2**31, 2**40, -3)}
    assert len(s) == 5 and all(0 <= v < 2**63 for v in s)
