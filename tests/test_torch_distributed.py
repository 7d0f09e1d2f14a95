"""The port's ``distributed/`` and ``launch/mesh.py`` on gloo ranks against
the reference on fake devices: ``sharded_decode_attention`` (one row's
last shard holds no valid key), ``ep_moe_ffn`` at capacity factors 8.0,
2.0 and 1.0 (where picks drop), ``decode_step(mesh=)`` on reduced dense
and moe configs against the reference's ``decode_step`` without a mesh,
the continuous engine with ``mesh=`` against itself without one, and
``moe_ffn(shard_experts=...)``. Then ``launch/steps.py``'s train and
serve steps on DTensors placed by the sharding rules, on 4 gloo ranks
(2 x 2), against the same steps on plain tensors.

The reference is one SPMD program over a mesh of devices; the port runs a
process per rank. So the port runs as 8 gloo ranks (a 2 data x 4 model
mesh; the engine on 2 ranks, 1 x 2), each a subprocess started here with
a ``FileStore`` under the test's temporary directory (no port is bound,
so parallel test workers cannot clash), and the reference runs in a JAX
subprocess on 8 fake CPU devices, as ``scripts/sharded_decode_check.py``
and ``scripts/ep_moe_check.py`` run it. Inputs are made here with numpy
and pass through ``.npz`` files; every rank's result must equal every
other rank's bit for bit. The rank processes import this module, so it
imports JAX and the reference only inside the functions that run them.

Bars: 2e-5 in fp32 for attention and the expert FFN (relative to the
output's scale for the expert FFN, whose weights are scaled up tenfold as
in the reference's check, so its outputs are O(10)), 2e-2 in bf16, 1e-4
in fp32 through a whole model."""
import dataclasses
import functools
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 4)                 # data x model: 8 gloo ranks, 8 fake devices
ENGINE_MESH = (1, 2)
TIMEOUT = 300                 # seconds, each subprocess
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MODEL_TOL = 1e-4
DECODE_SHAPE = (2, 512, 4, 2, 64)      # B, S, H, KVH, hd
DECODE_FILL = (300, 512)      # row 0: no valid key in the last 128
CACHE_LEN, DECODE_STEPS = 16, 10
STEPS_MESH = (2, 2)           # the steps on DTensors: 4 gloo ranks
STEPS_ROWS, STEPS_LEN = 4, 12  # the train batch
STEPS_TOL = 1e-5              # relative, fp32


class EPCase(NamedTuple):
    arch: str
    shared: int
    capacity_factor: float


EP_CASES = {"silu_cf8": EPCase("deepseek_v2_236b", 0, 8.0),
            "silu_cf1": EPCase("deepseek_v2_236b", 0, 1.0),
            "gelu_shared_cf2": EPCase("grok_1_314b", 1, 2.0)}


def _ep_cfg(get_config, name):
    """The reference's check's config (8 experts, top 2, d_model 64,
    d_ff 32), from either package's ``get_config``."""
    case = EP_CASES[name]
    return dataclasses.replace(
        get_config(case.arch).reduced(), num_experts=8, top_k=2,
        moe_d_ff=32, d_model=64, num_shared_experts=case.shared,
        compute_dtype="float32")


def _decode_cfg(get_config, name):
    arch = {"dense": "qwen2_5_7b", "moe": "grok_1_314b"}[name]
    return dataclasses.replace(
        get_config(arch).reduced(), num_layers=2, d_model=64, d_ff=128,
        num_heads=4, num_kv_heads=2, head_dim=32, vocab_size=259,
        compute_dtype="float32")


def _steps_cfg(get_config, name):
    """A reduced config of ``name``'s family in fp32 with the byte vocab,
    for the three steps on DTensors."""
    arch = {"dense": "qwen2_5_7b", "moe": "grok_1_314b"}[name]
    return dataclasses.replace(get_config(arch).reduced(), vocab_size=259,
                               compute_dtype="float32")


# -- nested dicts through flat .npz keys --------------------------------------

def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _tree(flat, prefix, fn=lambda a: a):
    tree = {}
    for key, a in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = fn(a)
    return tree


def _params(flat, prefix):
    """A param tree of the port from flat arrays, through the bridge."""
    from repro_torch.models.convert import params_from_reference
    return params_from_reference(_tree(flat, prefix), device="cpu")


def _load(path):
    with np.load(path) as f:
        return dict(f)


# -- what each gloo rank runs ---------------------------------------------------

def _rank_main(rank, world, shape, work, job):
    """One rank: join the gloo group through the work dir's FileStore,
    build the mesh, run ``job`` on the inputs, write ``rank{r}.npz``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    torch.set_num_threads(1)
    work = Path(work)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / "store"), world),
        rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh(*shape, device_type="cpu")
        with torch.no_grad():
            out = JOBS[job](mesh, _load(work / "inputs.npz"))
    finally:
        dist.destroy_process_group()
    np.savez(work / f"rank{rank}.npz", **out)


def _mesh_job(mesh, inp):
    from repro_torch.configs import get_config
    from repro_torch.distributed import ep_moe_ffn, sharded_decode_attention
    from repro_torch.models import attention, decode_step, init_cache
    out = {}
    valid = torch.from_numpy(inp["valid"])
    for dt in DTYPES:
        q, k, v = (torch.from_numpy(inp[n]).to(getattr(torch, dt))
                   for n in ("q", "k", "v"))
        out[f"decode/{dt}"] = sharded_decode_attention(
            q, k, v, valid, mesh=mesh).float().numpy()
    for name, case in EP_CASES.items():
        out[f"ep/{name}"] = ep_moe_ffn(
            _params(inp, f"ep/{name}/p/"),
            torch.from_numpy(inp[f"ep/{name}/x"]),
            _ep_cfg(get_config, name), mesh=mesh,
            capacity_factor=case.capacity_factor).numpy()
    out.update(_decode_steps(mesh, inp, get_config, attention, decode_step,
                             init_cache))
    return out


def _routed_through_the_mesh(attention):
    """Count the mesh route's calls; any ``decode_attention`` call
    raises."""
    from repro_torch.distributed import flash_decode
    calls = []
    real = flash_decode.sharded_decode_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def refused(*a, **kw):
        raise AssertionError("decode_attention on the mesh route")
    flash_decode.sharded_decode_attention = counted
    attention.decode_attention = refused
    return calls


def _decode_steps(mesh, inp, get_config, attention, decode_step, init_cache):
    calls = _routed_through_the_mesh(attention)
    out = {}
    for name in ("dense", "moe"):
        cfg = _decode_cfg(get_config, name)
        params = _params(inp, f"{name}/p/")
        toks, pos = inp[f"{name}/tokens"], inp[f"{name}/pos"]
        cache = init_cache(cfg, toks.shape[0], CACHE_LEN,
                           dtype=torch.float32, device="cpu")
        logits = []
        for t in range(toks.shape[1]):
            lt, cache = decode_step(params, cfg, cache,
                                    torch.from_numpy(toks[:, t]).long(),
                                    torch.from_numpy(pos[t]).long(),
                                    mesh=mesh)
            logits.append(lt.numpy())
        out[f"{name}/logits"] = np.stack(logits)
    out["mesh_calls"] = np.asarray(len(calls))
    return out


def _engine_job(mesh, inp):
    """The continuous engine with and without ``mesh`` on the same prompts
    and seed (fp32 weights, compute and cache), and a forward over the
    mesh run's tokens for its teacher-forced logprobs."""
    from repro_torch.configs import get_config
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine
    from repro_torch.models import attention, forward, init_params
    cfg = _decode_cfg(get_config, "dense")
    params = init_params(0, cfg, device="cpu")
    prompts = [inp[f"prompt{i}"].tolist() for i in range(int(inp["n"]))]
    out = {}
    for tag, m in (("plain", None), ("mesh", mesh)):
        if m is not None:
            calls = _routed_through_the_mesh(attention)
        eng = ContinuousBatchingEngine(
            cfg, num_slots=3, page_size=4, max_len=32, max_new_tokens=6,
            temperature=0.8, eos_id=-1, seed=7, dtype=torch.float32,
            device="cpu", mesh=m)
        fin, _ = eng.generate(params, [eng.make_sequence(p)
                                       for p in prompts])
        fin.sort(key=lambda q: q.uid)
        out[f"{tag}/answered"] = np.asarray([q.uid for q in fin])
        out[f"{tag}/pages_in_use"] = np.asarray(eng.pool.pages_in_use)
        for i, q in enumerate(fin):
            out[f"{tag}/tokens{i}"] = np.asarray(q.tokens)
            out[f"{tag}/lp{i}"] = np.asarray(q.logprobs[q.prompt_len:],
                                             np.float32)
            if m is not None:
                toks = torch.tensor([q.tokens])
                logp = torch.log_softmax(forward(params, cfg,
                                                 {"tokens": toks})[0][0]
                                         .float() / 0.8, -1)
                out[f"tf/lp{i}"] = np.asarray(
                    [float(logp[t - 1, q.tokens[t]])
                     for t in range(q.prompt_len, len(q.tokens))],
                    np.float32)
    out["mesh_calls"] = np.asarray(len(calls))
    return out


def _full(tree, prefix):
    """Flat numpy arrays of a tree of DTensors (whole) or tensors."""
    from torch.distributed.tensor import DTensor
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_full(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            v = v.full_tensor() if isinstance(v, DTensor) else v
            out[f"{prefix}{k}"] = v.detach().float().numpy()
    return out


def _steps_job(mesh, inp):
    """The train and serve steps of ``launch/steps.py`` on plain tensors
    and on DTensors placed by the sharding rules (``to_named``), for a
    reduced dense and moe model in fp32: the new params, the first
    moments and the metrics; the serve step's logits and cache at batch
    2 (rows split over "data") and at batch 1 (keys split over "data",
    combined by ``partial_decode_combine``)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.training import TrainState
    out = {}
    for name in ("dense", "moe"):
        cfg = _steps_cfg(get_config, name)
        params = init_params(0, cfg, device="cpu")
        batch = {k: torch.from_numpy(inp[f"steps/{k}"])
                 for k in ("tokens", "response_mask", "old_logprob",
                           "advantage")}
        train = steps.make_train_step(cfg)
        for tag in ("plain", "dtensor"):
            state = TrainState.create(params)
            b = batch
            if tag == "dtensor":
                state = dryrun.place_tree(
                    state, sharding.state_pspecs(state, cfg, mesh), mesh)
                b = dryrun.place_tree(
                    batch, sharding.batch_pspecs(batch, cfg, mesh), mesh)
                with dryrun.sharded(state.params, mesh):
                    new, metrics = train(state, b)
            else:
                new, metrics = train(state, b)
            out.update(_full(new.params, f"{name}/train/{tag}/p/"))
            out.update(_full(new.opt_state["m"], f"{name}/train/{tag}/m/"))
            out.update(_full(metrics, f"{name}/train/{tag}/metrics/"))
        serve = steps.make_serve_step(cfg)
        for B in (2, 1):
            cache = init_cache(cfg, B, CACHE_LEN, dtype=torch.float32,
                               device="cpu")
            toks = torch.from_numpy(inp["steps/tokens"][:B])
            for t in range(5):      # fill 5 positions, plain
                serve(params, cache, toks[:, t], torch.full((B,), t))
            tok, pos = toks[:, 5], torch.full((B,), 5)
            for tag in ("plain", "dtensor"):
                c = {k: v.clone() for k, v in cache.items()}
                key = f"{name}/serve{B}/{tag}/"
                if tag == "dtensor":
                    spec = sharding.P(*([sharding.dp_axes(mesh)] if B > 1
                                        else [None]))
                    pl = sharding.placements(spec, mesh)
                    p = dryrun.place_tree(
                        params, sharding.tree_pspecs(params, cfg, mesh),
                        mesh)
                    c = dryrun.place_tree(c, sharding.cache_pspecs(
                        c, cfg, mesh, batch=B), mesh)
                    out[key + "cache_placements"] = np.asarray(
                        [str(x) for x in c["k"].placements])
                    with dryrun.sharded(p, mesh):
                        logits, c = serve(p, c, dryrun.place(tok, pl, mesh),
                                          dryrun.place(pos, pl, mesh))
                else:
                    logits, c = serve(params, c, tok, pos)
                out.update(_full({"logits": logits, **c}, key))
    return out


JOBS = {"mesh": _mesh_job, "engine": _engine_job, "steps": _steps_job}


# -- what the reference's JAX subprocess runs ------------------------------------

def _reference_main(work):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.distributed.expert_parallel import ep_moe_ffn
    from repro.distributed.flash_decode import sharded_decode_attention
    work = Path(work)
    inp = _load(work / "inputs.npz")
    mesh = jax.make_mesh(MESH, ("data", "model"))
    out = {}
    with jax.set_mesh(mesh):                # jitted, as the checks run it
        decode = jax.jit(functools.partial(sharded_decode_attention,
                                           mesh=mesh, seq_axis="model"))
        for dt in DTYPES:
            q, k, v = (jnp.asarray(inp[n]).astype(dt)
                       for n in ("q", "k", "v"))
            out[f"decode/{dt}"] = np.asarray(
                decode(q, k, v, jnp.asarray(inp["valid"]))
                .astype(jnp.float32))
        for name, case in EP_CASES.items():
            ep = jax.jit(functools.partial(
                ep_moe_ffn, cfg=_ep_cfg(get_config, name), mesh=mesh,
                capacity_factor=case.capacity_factor))
            out[f"ep/{name}"] = np.asarray(ep(
                _tree(inp, f"ep/{name}/p/", jnp.asarray),
                jnp.asarray(inp[f"ep/{name}/x"])))
    np.savez(work / "reference.npz", **out)


# -- running them ----------------------------------------------------------------

def _start(code, work, log, **env):
    with open(log, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-c",
             "import test_torch_distributed as t; " + code],
            cwd=work, stdout=out, stderr=subprocess.STDOUT,
            env={**os.environ,
                 "PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}",
                 "OMP_NUM_THREADS": "1", **env})


def _ranks(work, shape, job):
    world = shape[0] * shape[1]
    return [_start(f"t._rank_main({r}, {world}, {shape}, {str(work)!r}, "
                   f"{job!r})", work, work / f"rank{r}.log")
            for r in range(world)]


def _wait(procs, logs):
    """Wait for every process, each within ``TIMEOUT`` of the start; kill
    all of them if one fails or overruns."""
    deadline = time.monotonic() + TIMEOUT
    try:
        for p, log in zip(procs, logs):
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            assert rc == 0, Path(log).read_text()[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _decode_reference(name, rng):
    """Reference params of a reduced config and its decode logits without
    a mesh over ragged positions, stepped here in JAX."""

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import decode_step, init_cache, init_params
    cfg = _decode_cfg(get_config, name)
    params = init_params(jax.random.PRNGKey(1), cfg)
    B, T = 4, DECODE_STEPS
    toks = rng.integers(3, 259, (B, T)).astype(np.int32)
    pos = np.stack([np.array([t, max(t - 1, 0), max(t - 3, 0), t])
                    for t in range(T)]).astype(np.int32)
    cache = init_cache(cfg, B, CACHE_LEN, dtype=jnp.float32)
    step = jax.jit(functools.partial(decode_step, cfg=cfg))
    logits = []
    for t in range(T):
        lj, cache = step(params, cache=cache, token=jnp.asarray(toks[:, t]),
                         pos=jnp.asarray(pos[t]))
        logits.append(np.asarray(lj, np.float32))
    return ({**_flat(params, f"{name}/p/"), f"{name}/tokens": toks,
             f"{name}/pos": pos}, np.stack(logits))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank worlds and the reference's subprocess, run at once."""
    rng = np.random.default_rng(0)
    B, S, H, KVH, hd = DECODE_SHAPE
    inp = {"q": rng.standard_normal((B, 1, H, hd)).astype(np.float32),
           "k": rng.standard_normal((B, S, KVH, hd)).astype(np.float32),
           "v": rng.standard_normal((B, S, KVH, hd)).astype(np.float32),
           "valid": np.arange(S)[None, :] < np.asarray(DECODE_FILL)[:, None]}
    from repro.configs import get_config
    for name in EP_CASES:
        cfg = _ep_cfg(get_config, name)
        d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        # weights at 10x the init scale, so the outputs are O(1) and more
        # (a zero-output comparison is vacuous), as the reference's check
        p = {"router": {"w": rng.normal(0, 0.2, (d, E))},
             "experts": {"up": rng.normal(0, 0.2, (E, d, f)),
                         "down": rng.normal(0, 0.2, (E, f, d))}}
        if cfg.activation == "silu":
            p["experts"]["gate"] = rng.normal(0, 0.2, (E, d, f))
        if cfg.num_shared_experts:
            fs = cfg.num_shared_experts * f
            p["shared"] = {"up": {"w": rng.normal(0, 0.2, (d, fs))},
                           "down": {"w": rng.normal(0, 0.2, (fs, d))}}
        inp.update(_flat(p, f"ep/{name}/p/"))
        inp[f"ep/{name}/x"] = rng.standard_normal((4, 8, d)).astype(
            np.float32)
    want = {}
    for name in ("dense", "moe"):
        more, want[f"{name}/logits"] = _decode_reference(name, rng)
        inp.update(more)
    prompts = [rng.integers(3, 259, n) for n in (3, 5, 4, 9, 6)]
    engine_inp = {"n": np.asarray(len(prompts)),
                  **{f"prompt{i}": p for i, p in enumerate(prompts)}}
    mask = np.zeros((STEPS_ROWS, STEPS_LEN), np.float32)
    mask[:, 4:] = 1.0
    steps_inp = {
        "steps/tokens": rng.integers(3, 259, (STEPS_ROWS, STEPS_LEN)),
        "steps/response_mask": mask,
        "steps/old_logprob": (-5.5 + 0.3 * rng.standard_normal(
            (STEPS_ROWS, STEPS_LEN))).astype(np.float32),
        "steps/advantage": rng.standard_normal(STEPS_ROWS).astype(
            np.float32)}

    work = {k: tmp_path_factory.mktemp(k)
            for k in ("mesh", "engine", "steps", "ref")}
    np.savez(work["mesh"] / "inputs.npz", **inp)
    np.savez(work["ref"] / "inputs.npz", **inp)
    np.savez(work["engine"] / "inputs.npz", **engine_inp)
    np.savez(work["steps"] / "inputs.npz", **steps_inp)
    procs = [_start(f"t._reference_main({str(work['ref'])!r})", work["ref"],
                    work["ref"] / "ref.log", JAX_PLATFORMS="cpu",
                    XLA_FLAGS="--xla_force_host_platform_device_count=8")]
    logs = [work["ref"] / "ref.log"]
    for key, shape in (("mesh", MESH), ("engine", ENGINE_MESH),
                       ("steps", STEPS_MESH)):
        procs += _ranks(work[key], shape, key)
        logs += [work[key] / f"rank{r}.log"
                 for r in range(shape[0] * shape[1])]
    _wait(procs, logs)

    def ranks(key, n):
        return [_load(work[key] / f"rank{r}.npz") for r in range(n)]
    return {"inputs": inp, "engine_inputs": engine_inp,
            "mesh": ranks("mesh", MESH[0] * MESH[1]),
            "engine": ranks("engine", ENGINE_MESH[0] * ENGINE_MESH[1]),
            "steps": ranks("steps", STEPS_MESH[0] * STEPS_MESH[1]),
            "reference": {**_load(work["ref"] / "reference.npz"), **want}}


def _same_on_every_rank(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])
    return results[0][key]


# -- the tests ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_sharded_decode_attention_matches_reference(runs, dtype):
    """Every rank returns the same (B,1,H,hd), equal to the reference's
    ``shard_map`` combine and to the port's plain decode; row 0's last
    shard holds no valid key and adds nothing (no NaN)."""
    from repro_torch.kernels.decode_attention import decode_attention_ref
    inp = runs["inputs"]
    S, n = DECODE_SHAPE[1], MESH[1]
    assert not inp["valid"][0, S - S // n:].any()
    got = _same_on_every_rank(runs["mesh"], f"decode/{dtype}")
    assert np.isfinite(got).all()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, runs["reference"][f"decode/{dtype}"],
                               atol=tol, rtol=tol)
    dt = getattr(torch, dtype)
    plain = decode_attention_ref(
        *(torch.from_numpy(inp[n]).to(dt) for n in ("q", "k", "v")),
        torch.from_numpy(inp["valid"])).float().numpy()
    np.testing.assert_allclose(got, plain, atol=tol, rtol=tol)


def test_partial_attention_of_an_empty_shard_is_zero():
    """A shard with no valid key: l = 0 and acc = 0, finite, as the
    reference's (``p`` masked to 0)."""
    import jax.numpy as jnp

    from repro.distributed.flash_decode import \
        _partial_attention as ref_partial
    from repro_torch.distributed.flash_decode import _partial_attention
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 8, 2, 32)).astype(np.float32)
            for _ in range(2))
    valid = np.zeros((2, 8), bool)
    valid[1, :3] = True
    got = _partial_attention(*map(torch.from_numpy, (q, k, v, valid)))
    want = ref_partial(*map(jnp.asarray, (q, k, v, valid)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)
    assert (got[1][0] == 0).all() and (got[2][0] == 0).all()
    assert (got[1][1] > 0).all()


def test_sharded_decode_attention_refuses_an_uneven_split():
    from repro_torch.distributed import sharded_decode_attention

    class Axis:
        def size(self):
            return 3

        def get_local_rank(self):
            return 0
    q = torch.zeros(1, 1, 2, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="do not split"):
        sharded_decode_attention(q, kv, kv, torch.ones(1, 8, dtype=bool),
                                 mesh={"model": Axis()})


def test_sort_dispatch_is_stable_and_matches_reference():
    """Many ties and a capacity that drops: buffers, slots and the kept
    mask equal the reference's (``jnp.argsort`` is stable, and so must
    the port's sort be)."""
    import jax.numpy as jnp

    from repro.distributed.expert_parallel import \
        _sort_dispatch as ref_sort
    from repro_torch.distributed.expert_parallel import _sort_dispatch
    rng = np.random.default_rng(2)
    M, d, n_dest, cap = 64, 8, 4, 9
    values = rng.standard_normal((M, d)).astype(np.float32)
    dest = rng.integers(0, n_dest, M)
    got = _sort_dispatch(torch.from_numpy(values), torch.from_numpy(dest),
                         n_dest, cap)
    want = ref_sort(jnp.asarray(values), jnp.asarray(dest, jnp.int32),
                    n_dest, cap)
    assert not bool(got[3].all())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a stable sort keeps each destination's items in their first order
    for j in range(n_dest):
        first = np.flatnonzero(dest == j)[:cap]
        np.testing.assert_array_equal(got[0][j, :len(first)].numpy(),
                                      values[first])


def _ep_oracle(inp, name, *, reference_fault):
    """``ep_moe_ffn``'s result on the ``MESH``, read pick by pick in
    float64, independent of both packages' code. Each ``dp`` slice routes
    its own tokens (router logits and softmax in fp32, top k, gates
    renormalised). A pick (token t, choice j), in flat order t*k + j, is
    kept at the first hop while fewer than C picks went before it to its
    expert's rank, and at the second hop while fewer than C2 kept picks
    went before it to its expert; its gate then weights that expert's FFN
    of the token. With ``reference_fault`` a rank that drops a pick runs
    the first pick it received through its local expert 0, as the
    reference's id scatter does on the CPU (ROADMAP §3)."""
    from repro_torch.configs import get_config
    cfg = _ep_cfg(get_config, name)
    pre = f"ep/{name}/p/"
    w = inp[pre + "router/w"]
    up, down = (inp[pre + f"experts/{n}"].astype(np.float64)
                for n in ("up", "down"))
    gate = inp.get(pre + "experts/gate")

    def act(h):
        if cfg.activation == "silu":
            return h / (1 + np.exp(-h))
        return 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (h + 0.044715 * h ** 3)))

    def ffn(e, t):
        h = t @ up[e]
        h = h * act(t @ gate[e].astype(np.float64)) if gate is not None \
            else act(h)
        return h @ down[e]

    x = inp[f"ep/{name}/x"]
    dp, ep = MESH
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    E_loc, N = E // ep, B // dp * S
    C = int(max(1, -(-N * k // ep) * EP_CASES[name].capacity_factor))
    C2 = int(max(1, -(-ep * C // E_loc)))
    xf = x.reshape(B * S, d)
    y = np.zeros((B * S, d))
    for s in range(dp):
        xs = xf[s * N:(s + 1) * N]
        logits = xs.astype(np.float32) @ w.astype(np.float32)
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        eids = np.argsort(-probs, -1, kind="stable")[:, :k]
        gates = np.take_along_axis(probs, eids, -1)
        gates = gates / (gates.sum(-1, keepdims=True) + 1e-9)
        sent, kept = [0] * ep, []
        for t in range(N):
            for j in range(k):
                e = int(eids[t, j])
                if sent[e // E_loc] < C:
                    kept.append((t, j, e, sent[e // E_loc] == 0))
                sent[e // E_loc] += 1
        queued = [0] * E
        for t, j, e, first in kept:
            if reference_fault and first and sent[e // E_loc] > C:
                e = e // E_loc * E_loc
            if queued[e] < C2:
                y[s * N + t] += float(gates[t, j]) * ffn(
                    e, xs[t].astype(np.float64))
            queued[e] += 1
    if pre + "shared/up/w" in inp:
        h = act(xf @ inp[pre + "shared/up/w"].astype(np.float64))
        y += h @ inp[pre + "shared/down/w"].astype(np.float64)
    return y.reshape(x.shape)


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_moe_ffn_matches_reference(runs, name):
    """``ep_moe_ffn`` on the 2 x 4 mesh: the same y on every rank, equal
    to the reference's, drops included (at capacity factor 1.0), on every
    token that the reference's CPU fault leaves alone. At 1.0 that fault
    (ROADMAP §3) sends some kept picks to the wrong expert: the oracle
    with the fault equals the reference on every token, and the tokens
    where the two oracles differ are those left out here."""
    got = _same_on_every_rank(runs["mesh"], f"ep/{name}")
    want = runs["reference"][f"ep/{name}"]
    scale = float(np.abs(want).max())
    assert scale > 0.5, f"vacuous comparison (scale {scale})"
    tol = {"atol": TOL["float32"] * scale, "rtol": TOL["float32"]}
    faulted = _ep_oracle(runs["inputs"], name, reference_fault=True)
    np.testing.assert_allclose(want, faulted, **tol)
    moved = (faulted != _ep_oracle(runs["inputs"], name,
                                   reference_fault=False)).any(-1)
    assert moved.any() == (name == "silu_cf1"), moved.sum()
    np.testing.assert_allclose(got[~moved], want[~moved], **tol)


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_moe_ffn_matches_a_drop_aware_oracle(runs, name):
    """``ep_moe_ffn`` equals the pick-by-pick oracle on every token, the
    dropped picks of capacity factor 1.0 included: each kept pick goes
    through the expert it chose."""
    got = _same_on_every_rank(runs["mesh"], f"ep/{name}")
    want = _ep_oracle(runs["inputs"], name, reference_fault=False)
    scale = float(np.abs(want).max())
    assert scale > 0.5, f"vacuous comparison (scale {scale})"
    np.testing.assert_allclose(got, want, atol=TOL["float32"] * scale,
                               rtol=TOL["float32"])


def test_ep_moe_ffn_without_drops_equals_moe_ffn(runs):
    """At capacity factor 8.0 nothing drops, so the expert-parallel FFN
    equals the one-device ``moe_ffn`` at a capacity that drops nothing;
    at 1.0 picks drop and the output moves."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_ffn
    inp = runs["inputs"]
    for name in ("silu_cf8", "gelu_shared_cf2"):
        cfg = _ep_cfg(get_config, name)
        with torch.no_grad():
            want, _ = moe_ffn(_params(inp, f"ep/{name}/p/"),
                              torch.from_numpy(inp[f"ep/{name}/x"]), cfg,
                              capacity_factor=8.0)
        got = runs["mesh"][0][f"ep/{name}"]
        scale = float(want.abs().max())
        assert scale > 0.5
        np.testing.assert_allclose(got, want.numpy(),
                                   atol=TOL["float32"] * scale,
                                   rtol=TOL["float32"])
    moved = np.abs(runs["mesh"][0]["ep/silu_cf1"]
                   - runs["mesh"][0]["ep/silu_cf8"]).max()
    assert moved > 1e-2


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_decode_step_with_mesh_matches_reference(runs, name):
    """``decode_step(mesh=)`` on 8 ranks over ragged positions: every
    step's logits against the reference's ``decode_step`` without a mesh;
    every attention call took the mesh route, none ``decode_attention``."""
    got = _same_on_every_rank(runs["mesh"], f"{name}/logits")
    np.testing.assert_allclose(got, runs["reference"][f"{name}/logits"],
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    assert int(runs["mesh"][0]["mesh_calls"]) == 2 * DECODE_STEPS * 2


def test_continuous_engine_with_mesh_matches_itself_without(runs):
    """The continuous engine on 2 ranks with ``mesh=``: every request
    answered once with the tokens the engine samples without a mesh,
    logprobs within 1e-4 of that run's and of a forward over the tokens
    (fp32), no page left in use, the same on both ranks."""
    ranks = runs["engine"]
    n = int(runs["engine_inputs"]["n"])
    res = ranks[0]
    for tag in ("plain", "mesh"):
        ids = _same_on_every_rank(ranks, f"{tag}/answered")
        assert sorted(ids.tolist()) == list(range(n))
        assert int(res[f"{tag}/pages_in_use"]) == 0
    assert int(res["mesh_calls"]) > 0
    for i in range(n):
        toks = _same_on_every_rank(ranks, f"mesh/tokens{i}")
        np.testing.assert_array_equal(toks, res[f"plain/tokens{i}"])
        lp = _same_on_every_rank(ranks, f"mesh/lp{i}")
        assert len(lp) == 6
        for want in (res[f"plain/lp{i}"], res[f"tf/lp{i}"]):
            np.testing.assert_allclose(lp, want, atol=MODEL_TOL,
                                       rtol=MODEL_TOL)


def test_moe_ffn_shard_experts_matches_reference():
    """``shard_experts`` sees the (E, C, d) dispatch buffer and then the
    output buffer, as in the reference; with an identity hook the output
    equals the reference's."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models import moe as jmoe
    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe
    from repro_torch.models.convert import params_from_reference
    ref_cfg = _ep_cfg(ref_get_config, "silu_cf1")
    cfg = _ep_cfg(get_config, "silu_cf1")
    pj = jmoe.init_moe(jax.random.PRNGKey(3), ref_cfg)
    pt = params_from_reference(jax.tree.map(np.asarray, pj), device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 6, 64)).astype(
        np.float32)
    seen = {"ref": [], "port": []}

    def hook(key):
        def f(buf):
            seen[key].append(tuple(buf.shape))
            return buf
        return f
    yj, aj = jmoe.moe_ffn(pj, jnp.asarray(x), ref_cfg,
                          shard_experts=hook("ref"))
    with torch.no_grad():
        yt, at = tmoe.moe_ffn(pt, torch.from_numpy(x), cfg,
                              shard_experts=hook("port"))
    C = tmoe.capacity(12, cfg)
    assert seen["port"] == seen["ref"] == [(8, C, 64)] * 2
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _tree_rel(res, got, want):
    keys = sorted(k[len(want):] for k in res if k.startswith(want))
    assert keys and keys == sorted(k[len(got):] for k in res
                                   if k.startswith(got))
    num = sum(np.sum((res[got + k].astype(np.float64)
                      - res[want + k]) ** 2) for k in keys)
    den = sum(np.sum(res[want + k].astype(np.float64) ** 2) for k in keys)
    return np.sqrt(num / den)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_train_step_on_dtensors_matches_the_plain_step(runs, name):
    """``make_train_step`` on DTensors placed by the rules over 2 x 2 gloo
    ranks (FSDP over "data", tensor and expert parallel over "model")
    against the same step on plain tensors, fp32: the metrics, the new
    params and the first moments (the clipped gradients, scaled) each
    within 1e-5 relative; the same on every rank."""
    for key in runs["steps"][0]:
        if key.startswith(f"{name}/train/dtensor/"):
            _same_on_every_rank(runs["steps"], key)
    res = runs["steps"][0]
    pre = f"{name}/train/"
    for k in [k for k in res if k.startswith(pre + "plain/metrics/")]:
        m = k.rsplit("/", 1)[1]
        np.testing.assert_allclose(res[pre + "dtensor/metrics/" + m], res[k],
                                   rtol=STEPS_TOL, atol=1e-7, err_msg=m)
    for part in ("p", "m"):
        assert _tree_rel(res, pre + f"dtensor/{part}/",
                         pre + f"plain/{part}/") <= STEPS_TOL, part


@pytest.mark.parametrize("B", [2, 1])
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_serve_step_on_dtensors_matches_the_plain_step(runs, name, B):
    """``make_serve_step`` on DTensors against plain tensors, fp32: the
    logits and the cache written in place within 1e-5 relative. At batch
    2 the cache's rows split over "data"; at batch 1 its keys do, and the
    decode attention combines the shards' partial softmaxes."""
    res = runs["steps"][0]
    pre = f"{name}/serve{B}/"
    # the stacked cache (L, B, S, KVH, hd): rows or keys over "data"
    split = "S(1)" if B > 1 else "S(2)"
    assert res[pre + "dtensor/cache_placements"][0] == split
    for key in ("logits", "k", "v"):
        got = _same_on_every_rank(runs["steps"], pre + "dtensor/" + key)
        assert _rel(got, res[pre + "plain/" + key]) <= STEPS_TOL, key
