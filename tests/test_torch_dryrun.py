"""The port's dry run (``repro_torch/launch/{specs,steps,dryrun}.py``) and
the kernel wrappers' meta route, against the reference where it has a
counterpart.

* Step shapes: for one reduced config of each family, each of the three
  steps on meta DTensors over a fake 2 x 2 mesh and a 2 x 2 x 2 mesh with
  "pod" traces to the end, and its outputs' shapes and dtypes equal
  ``jax.eval_shape`` of the reference's step on the same config.
* The byte account: ``argument_bytes_per_rank`` equals a sum over the
  placements' local shapes computed here from the specs; a 1 x 1 mesh
  sends no collective.
* The meta route: each wrapper on meta tensors gives its plain version's
  shapes and dtypes.
* The steps themselves on plain CPU tensors against the reference's
  jitted steps on the same params (fp32; the bars of
  ``test_torch_planner.py``'s ``grpo_train_step`` check).
* The launcher: one full-size run, ``qwen2_5_7b decode_32k single`` on 256
  fake ranks, in a subprocess that imports no JAX.

The fake process group is process-wide: each fixture that starts one
destroys it on teardown."""
import dataclasses
import functools
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import tiny_cfg
from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.launch import steps as ref_steps
from repro.models import init_cache as ref_init_cache
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, specs, steps
from repro_torch.models import init_cache
from repro_torch.models.convert import params_from_reference
from repro_torch.tree import tree_leaves

SRC = Path(__file__).resolve().parents[1] / "src"
FAMILIES = {"dense": "qwen2_5_7b", "moe": "grok_1_314b",
            "moe_mla": "deepseek_v2_236b", "vlm": "internvl2_26b",
            "ssm": "falcon_mamba_7b", "hybrid": "recurrentgemma_9b",
            "audio": "whisper_tiny"}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


@pytest.fixture(params=sorted(MESHES))
def mesh(request):
    assert not dist.is_initialized()
    try:
        yield dryrun.fake_mesh(*MESHES[request.param])
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _reference_outputs(arch, shape):
    """``jax.eval_shape`` of the reference's step on its reduced config."""
    cfg = ref_get_config(arch).reduced()
    kind, sp = ref_specs.input_specs(cfg, shape)
    if kind == "train":
        return jax.eval_shape(ref_steps.make_train_step(cfg),
                              ref_specs.state_struct(cfg), sp["batch"])
    p = ref_specs.params_struct(cfg)
    if kind == "prefill":
        return jax.eval_shape(ref_steps.make_prefill_step(cfg), p,
                              sp["batch"])
    return jax.eval_shape(ref_steps.make_serve_step(cfg, ring=sp["ring"]),
                          p, sp["cache"], sp["token"], sp["pos"])


def _leaves(tree):
    """{path: (shape, dtype name)} of the port's tensors."""
    return {path: (tuple(x.shape), str(x.dtype).split(".")[-1])
            for path, x in sharding._with_paths(tree)
            if isinstance(x, torch.Tensor)}


def _ref_leaves(tree):
    """{path: (shape, dtype name)} of the reference's arrays."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_steps_trace_on_meta_dtensors_with_the_references_shapes(mesh,
                                                                  family):
    """On 2 x 2 x 2 the dense family runs the prefill and decode steps and
    the others the decode step: DTensor weighs each op's strategies over
    the product of the mesh dims, and one family's three steps there took
    15-48 s of CPU (the actor update most of it) against 3-11 s on 2 x 2.
    The pod axis splits the batch (with "data") and all-reduces the
    gradients, the same code for every family; the sweep runs every
    family's three steps on 2 x 16 x 16."""
    arch = FAMILIES[family]
    cfg = get_config(arch).reduced()
    shapes = SHAPES if mesh.ndim == 2 else \
        SHAPES[1:] if family == "dense" else SHAPES[2:]
    for shape in shapes:
        step, args = dryrun.build_step(cfg, shape, mesh)
        out, account = dryrun.trace(step, args, mesh)
        want = _reference_outputs(arch, shape)
        if shape == "train_4k":
            state, metrics = out
            want_state, want_metrics = want
            assert set(metrics) == set(want_metrics), family
            assert all(m.shape == () for m in metrics.values())
            assert _leaves(state.params) == _ref_leaves(want_state.params)
            for mom in ("m", "v"):
                assert _leaves(state.opt_state[mom]) == \
                    _ref_leaves(want_state.opt_state[mom])
            assert state.step == 1
        else:
            logits, cache = out
            assert _leaves({"x": logits}) == _ref_leaves({"x": want[0]}), \
                (family, shape)
            assert (cache is None) == (want[1] is None)
            if cache is not None:
                assert _leaves(cache) == _ref_leaves(want[1]), (family,
                                                                 shape)
        assert account["peak_bytes_per_rank"] >= \
            account["argument_bytes_per_rank"] > 0
        assert account["collective_bytes"]["total"] > 0


def _expected_argument_bytes(tree, specs_tree, mesh):
    """Local bytes of ``tree`` under ``specs_tree``, from the specs."""
    leaves = dict(sharding._with_paths(tree))
    total = 0
    for path, spec in sharding._with_paths(specs_tree):
        leaf = leaves[path]
        if isinstance(leaf, torch.Tensor):
            local = sharding.local_shape(leaf.shape,
                                         sharding.placements(spec, mesh),
                                         mesh)
            total += math.prod(local) * leaf.element_size()
    return total


def test_argument_bytes_are_the_local_shards(mesh):
    """Train: the state and the batch; decode: params, cache, token and
    position, each leaf's local shape from its spec."""
    cfg = get_config("deepseek_v2_236b").reduced()
    state = specs.state_struct(cfg)
    batch = specs.train_specs(cfg)
    want = (_expected_argument_bytes(
        state, sharding.state_pspecs(state, cfg, mesh), mesh)
        + _expected_argument_bytes(
            batch, sharding.batch_pspecs(batch, cfg, mesh), mesh))
    # what ``trace`` records as argument_bytes_per_rank
    assert dryrun.local_bytes(dryrun.build_step(cfg, "train_4k", mesh)[1]) \
        == want
    cfg = get_config("qwen2_5_7b").reduced()
    params = specs.params_struct(cfg)
    cache, tok, pos, _ = specs.decode_specs(cfg, "long_500k")
    want = (_expected_argument_bytes(
        params, sharding.tree_pspecs(params, cfg, mesh), mesh)
        + _expected_argument_bytes(cache, sharding.cache_pspecs(
            cache, cfg, mesh, batch=1), mesh)
        + 2 * tok.numel() * tok.element_size())
    step, args = dryrun.build_step(cfg, "long_500k", mesh)
    _, account = dryrun.trace(step, args, mesh)
    assert account["argument_bytes_per_rank"] == want
    # batch 1: the keys split over "data", combined by all-reduces
    assert account["collective_ops"]["allreduce_"] == 2 * cfg.num_layers


@pytest.fixture
def one_rank_mesh():
    assert not dist.is_initialized()
    try:
        yield dryrun.fake_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_a_one_by_one_mesh_sends_nothing(one_rank_mesh):
    cfg = get_config("grok_1_314b").reduced()
    for shape in SHAPES:
        step, args = dryrun.build_step(cfg, shape, one_rank_mesh)
        _, account = dryrun.trace(step, args, one_rank_mesh)
        assert account["collective_ops"] == {}, shape
        assert account["collective_bytes"] == {"total": 0}


# -- the meta route -----------------------------------------------------------

def _kernel_cases():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_rl_loss.ops import (fused_rl_loss_bwd,
                                                       fused_rl_loss_fwd)
    from repro_torch.kernels.grpo_logprob import grpo_logprob
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.rglru_scan import rglru_scan
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)
    N, V = 6, 40
    ids = torch.randint(0, V, (N,), generator=g)
    return {
        "flash_attention": (flash_attention, (r(2, 8, 4, 64, dtype=torch.bfloat16),
                                              r(2, 8, 2, 64, dtype=torch.bfloat16),
                                              r(2, 8, 2, 64, dtype=torch.bfloat16))),
        "decode_attention": (decode_attention, (
            r(2, 1, 4, 32), r(2, 16, 2, 32), r(2, 16, 2, 32),
            torch.arange(16)[None, :] < torch.tensor([[5], [16]]))),
        "mamba_scan": (mamba_scan, (r(2, 5, 8, dtype=torch.bfloat16),
                                    r(2, 5, 8).abs(), -r(8, 16).abs(),
                                    r(2, 5, 16), r(2, 5, 16))),
        "rglru_scan": (rglru_scan, (r(2, 5, 8).sigmoid(), r(2, 5, 8))),
        "grpo_logprob": (grpo_logprob, (r(N, V, dtype=torch.bfloat16), ids)),
        "fused_rl_loss_fwd": (fused_rl_loss_fwd, (r(N, V), ids, r(N), r(N),
                                                  r(N))),
        "fused_rl_loss_bwd": (fused_rl_loss_bwd, (r(N, V, dtype=torch.bfloat16),
                                                  ids, r(N), r(N), r(N),
                                                  r(N))),
    }


@pytest.mark.parametrize("name", sorted(_kernel_cases()))
def test_meta_route_gives_the_plain_versions_shapes(name):
    wrapper, args = _kernel_cases()[name]
    launches = wrapper.launches
    plain = wrapper(*args)
    meta = wrapper(*(a.to("meta") for a in args))
    plain = plain if isinstance(plain, tuple) else (plain,)
    meta = meta if isinstance(meta, tuple) else (meta,)
    assert [(m.shape, m.dtype) for m in meta] == \
        [(p.shape, p.dtype) for p in plain]
    assert all(m.is_meta for m in meta)
    assert wrapper.launches == launches


def test_meta_route_refuses_what_the_kernel_refuses():
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.empty(1, 8, 4, 48, device="meta")
    with pytest.raises(ValueError, match="unsupported shapes"):
        flash_attention(q, q, q)


# -- the steps against the reference's, on plain CPU tensors -------------------

def _pair(compute="float32", **kw):
    ref_cfg = dataclasses.replace(tiny_cfg(**kw), compute_dtype=compute)
    from repro.models import init_params as ref_init
    ref_params = ref_init(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return ref_cfg, ref_params, ModelConfig(**dataclasses.asdict(ref_cfg)), \
        params


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_prefill_and_serve_steps_match_the_references():
    """Last-token logits and the cache of the prefill, then the logits and
    cache of one serve step, within 1e-5 relative in fp32."""
    ref_cfg, ref_params, cfg, params = _pair()
    tokens = np.random.default_rng(4).integers(3, 259, (2, 12))
    lj, cj = jax.jit(ref_steps.make_prefill_step(ref_cfg))(
        ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    lt, ct = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(tokens)})
    assert _rel(lt.numpy(), lj) <= 1e-5
    for k in ("k", "v"):
        assert _rel(ct["kv"][k].float().numpy(),
                    np.asarray(cj["kv"][k], np.float32)) <= 1e-5
    S = 16
    cache_j = ref_init_cache(ref_cfg, 2, S, dtype=jnp.float32)
    cache_j = {k: v.at[:, :, :12].set(cj["kv"][k]) for k, v in
               cache_j.items()}
    cache_t = init_cache(cfg, 2, S, dtype=torch.float32, device="cpu")
    for k in ("k", "v"):
        cache_t[k][:, :, :12] = ct["kv"][k]
    tok, pos = np.array([5, 9]), np.array([12, 12])
    lj, cache_j = jax.jit(ref_steps.make_serve_step(ref_cfg))(
        ref_params, cache_j, jnp.asarray(tok, jnp.int32),
        jnp.asarray(pos, jnp.int32))
    lt, cache_t = steps.make_serve_step(cfg)(
        params, cache_t, torch.from_numpy(tok), torch.from_numpy(pos))
    assert _rel(lt.numpy(), lj) <= 1e-5
    for k in ("k", "v"):
        assert _rel(cache_t[k].numpy(), cache_j[k]) <= 1e-5


def test_train_step_matches_the_references():
    """``make_train_step`` with the default GRPO and AdamW configs: the
    metrics within 1e-5 relative, the new params within 1e-5 relative as
    one tree and 1e-4 leaf by leaf (the bars of the planner test's
    ``grpo_train_step`` check)."""
    from repro.training import TrainState as RefTrainState
    from repro_torch.models.convert import params_to_reference
    from repro_torch.training import TrainState
    ref_cfg, ref_params, cfg, params = _pair()
    rng = np.random.default_rng(3)
    B, S = 4, 20
    mask = np.zeros((B, S), np.float32)
    mask[:, 6:] = 1.0
    batch = {"tokens": rng.integers(3, 259, (B, S)),
             "response_mask": mask,
             "old_logprob": (-5.5 + 0.3 * rng.standard_normal((B, S)))
             .astype(np.float32),
             "advantage": rng.standard_normal(B).astype(np.float32)}
    new_ref, m_ref = jax.jit(ref_steps.make_train_step(ref_cfg))(
        RefTrainState.create(ref_params),
        {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
         for k, v in batch.items()})
    new, m = steps.make_train_step(cfg)(
        TrainState.create(params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert new.step == int(new_ref.step) == 1
    assert set(m) == set(m_ref)
    for k in m_ref:
        np.testing.assert_allclose(float(m[k]), float(m_ref[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    num = den = 0.0
    for a, b in zip(jax.tree.leaves(params_to_reference(new.params)),
                    jax.tree.leaves(new_ref.params)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
        num, den = num + np.sum((a - b) ** 2), den + np.sum(b * b)
    assert np.sqrt(num) <= 1e-5 * np.sqrt(den)


# -- the launcher ---------------------------------------------------------------

def test_launcher_runs_full_size_without_jax():
    code = (
        "import sys, json, io, contextlib\n"
        "from repro_torch.launch import dryrun\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    rc = dryrun.main(['--arch', 'qwen2_5_7b', '--shape',"
        " 'decode_32k', '--mesh', 'single'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax',"
        " 'repro')]\n"
        "assert not bad, bad\n"
        "print(buf.getvalue())\n"
        "sys.exit(rc)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:] + res.stdout[-3000:]
    rec = json.loads(res.stdout)
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    # per rank: B = 128 over 16 "data" ranks; KV heads 4 do not split 16
    cfg = get_config("qwen2_5_7b")
    cache = 2 * cfg.num_layers * 8 * 32768 * 4 * 128 * 2
    assert cache < rec["argument_bytes_per_rank"] < 2 * cache
    for key in ("trace_s", "collective_ops", "collective_bytes",
                "output_bytes_per_rank", "peak_bytes_per_rank", "flops",
                "t_compute", "bottleneck", "useful_flops_ratio"):
        assert key in rec, key
