"""The parameter bridge between the reference and the port, the port's
import boundary, and its default device."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)

SRC = Path(__file__).resolve().parents[1] / "src"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_reference_params_bit_exactly(tiny_dense_params,
                                                          dtype):
    ref = jax.tree.map(lambda a: np.asarray(a.astype(dtype)),
                       tiny_dense_params)
    port = params_from_reference(ref, device="cpu")
    # same keys, shapes (stacked layer axis included) and dtype; no copies
    # of one tensor into another
    for (kr, a), (kp, t) in zip(_leaves(ref), _leaves(port)):
        assert kr == kp and tuple(t.shape) == a.shape
        assert t.dtype == getattr(torch, dtype) and t.device.type == "cpu"
    assert port["blocks"]["attn"]["wq"]["w"].shape[0] == 2   # layer axis
    back = params_to_reference(port)
    for (kr, a), (kb, b) in zip(_leaves(ref), _leaves(back)):
        assert kr == kb and b.dtype == a.dtype
        assert a.tobytes() == b.tobytes()
    # and the reference runs on what came back
    tokens = jnp.asarray(np.arange(8, dtype=np.int32)[None] % 200 + 3)
    from conftest import tiny_cfg
    from repro.models import forward
    l0, _ = forward(ref, tiny_cfg(), {"tokens": tokens})
    l1, _ = forward(back, tiny_cfg(), {"tokens": tokens})
    np.testing.assert_array_equal(np.asarray(l0), np.asarray(l1))


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert len(names) > 30, names\n"
        "for n in ('repro_torch.rl.ppo', 'repro_torch.training.checkpoint',"
        " 'repro_torch.core.recovery.snapshot', 'repro_torch.api.service',"
        " 'repro_torch.autodiff', 'repro_torch.launch.serve',"
        " 'repro_torch.core.planner.profiling', 'repro_torch.models.moe',"
        " 'repro_torch.models.mla', 'repro_torch.models.encdec',"
        " 'repro_torch.distributed.flash_decode',"
        " 'repro_torch.distributed.expert_parallel',"
        " 'repro_torch.launch.mesh', 'repro_torch.distributed.sharding',"
        " 'repro_torch.launch.specs', 'repro_torch.launch.steps',"
        " 'repro_torch.launch.dryrun', 'repro_torch.launch.sweep',"
        " 'repro_torch.kernels._routes'):\n"
        "    assert n in names, n\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 30


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_cache, init_params
    from repro_torch.rl import generate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2_5_7b").reduced()
    calls = [
        lambda: init_params(0, cfg),
        lambda: init_cache(cfg, 1, 8),
        lambda: ContinuousBatchingEngine(cfg),
        lambda: generate({}, cfg, [np.array([1, 5, 6])], 0),
        lambda: params_from_reference({"w": np.zeros(2, np.float32)}),
        lambda: serve.main(["--requests", "1"]),
        lambda: make_debug_mesh(1, 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
