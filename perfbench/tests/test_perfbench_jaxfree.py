"""No module the benchmark runs is JAX or the JAX package: a fresh
process loads what ``run.py`` and ``limits.py`` load, runs both drivers
at a small size on the CPU, and lists the top-level names it holds."""
import json
import os
import subprocess
import sys

from perfbench.core.spec import ROOT

SCRIPT = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import perfbench.run, perfbench.limits
from perfbench.core import result
from perfbench.tests.common import run_tiny
run_tiny("qwen2_5_7b_l18", "rollout_groups", seconds=0.2)
run_tiny("qwen2_5_7b_l3", "grpo_math", seconds=0.2)
print(json.dumps(result.forbidden_modules()))
"""


def test_no_jax_in_the_process():
    env = dict(os.environ, PYTHONPATH="", USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_check_compares_whole_names():
    from perfbench.core import result
    sys.modules.setdefault("repro_torch_lookalike", object())
    assert "repro_torch_lookalike".split(".")[0] not in result.FORBIDDEN
    assert "repro" in result.FORBIDDEN


def test_run_refuses_a_machine_without_the_card():
    """On a machine without CUDA devices run.py prints no result and
    exits with another code than 0."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "qwen7b.rollout",
         "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=str(ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""
