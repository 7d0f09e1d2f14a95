"""The port's sharding rules (``repro_torch/distributed/sharding.py``)
against the reference's (``repro/distributed/sharding.py``), leaf by leaf.

The reference's rules run on ``AbstractMesh``es (no devices): 16 x 16
(data x model), 2 x 16 x 16 with "pod", and 2 x 4, where many of the
rules' axis drops (an axis that does not divide its dim) happen. The port's
take a ``MeshShape`` of the same names and sizes. For every leaf of all
12 archs' params, the AdamW state of four of them, the decode caches of
``decode_32k`` and ``long_500k`` with and without ``kv_seq_shard``, and
the batches of ``train_4k`` and ``prefill_32k``: the port's spec equals the
reference's, and the local shape under the port's DTensor placements
equals ``NamedSharding(mesh, spec).shard_shape(shape)``. Last, the port's
placements are held to what DTensor makes of them on a fake process group
(one 2 x 4 mesh, torn down after the test)."""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_sharding
from repro.launch import specs as ref_specs
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.launch import specs

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
STATE_ARCHS = ("qwen2_5_7b", "deepseek_v2_236b", "falcon_mamba_7b",
               "recurrentgemma_9b")


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), sharding.MeshShape(sizes, names)


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _port_paths(tree):
    return dict(sharding._with_paths(tree))


@functools.lru_cache(maxsize=None)
def _params(arch):
    return (ref_specs.params_struct(ref_get_config(arch)),
            specs.params_struct(get_config(arch)))


def _same(ref_specs_tree, ref_tree, port_specs_tree, port_tree, mesh_name):
    """Every leaf: equal specs, and the port's local shape under its
    placements equals the reference's shard shape. Returns the count."""
    ref_mesh, mesh = _meshes(mesh_name)
    ref_s, ref_l = _ref_paths(ref_specs_tree), _ref_paths(ref_tree)
    port_s, port_l = _port_paths(port_specs_tree), _port_paths(port_tree)
    assert set(port_s) == set(ref_s) == set(ref_l) == set(port_l)
    for path, spec in port_s.items():
        want = ref_s[path]
        assert isinstance(spec, sharding.P), path
        assert tuple(spec) == tuple(want), (path, spec, want)
        shape = tuple(port_l[path].shape)
        assert shape == tuple(ref_l[path].shape), path
        local = sharding.local_shape(shape, sharding.placements(spec, mesh),
                                     mesh)
        assert local == tuple(NamedSharding(ref_mesh, want)
                              .shard_shape(shape)), (path, spec)
    return len(port_s)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    ref_p, p = _params(arch)
    ref_mesh, mesh = _meshes(mesh_name)
    n = _same(ref_sharding.tree_pspecs(ref_p, ref_get_config(arch),
                                       ref_mesh), ref_p,
              sharding.tree_pspecs(p, get_config(arch), mesh), p, mesh_name)
    assert n == len(jax.tree.leaves(ref_p))


def test_every_arch_has_its_leaves():
    """243 parameter leaves between the 12 archs (the reference's count)."""
    assert sum(len(_port_paths(_params(a)[1])) for a in ARCH_IDS) == 243


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_state_specs_equal_the_reference(arch, mesh_name):
    ref_st = ref_specs.state_struct(ref_get_config(arch))
    st = specs.state_struct(get_config(arch))
    ref_mesh, mesh = _meshes(mesh_name)
    ref_sp = ref_sharding.state_pspecs(ref_st, ref_get_config(arch),
                                       ref_mesh)
    sp = sharding.state_pspecs(st, get_config(arch), mesh)
    for key in ("m", "v"):
        _same(ref_sp.opt_state[key], ref_st.opt_state[key],
              sp.opt_state[key], st.opt_state[key], mesh_name)
    _same(ref_sp.params, ref_st.params, sp.params, st.params, mesh_name)
    assert sp.step == sp.opt_state["count"] == sharding.P() \
        and tuple(ref_sp.step) == tuple(ref_sp.opt_state["count"]) == ()


@pytest.mark.parametrize("kv_seq_shard", [False, True])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cache_specs_equal_the_reference(mesh_name, shape, kv_seq_shard):
    ref_mesh, mesh = _meshes(mesh_name)
    for arch in ARCH_IDS:
        ref_cache, ref_tok, _, _ = ref_specs.decode_specs(
            ref_get_config(arch), shape)
        cache, tok, _, _ = specs.decode_specs(get_config(arch), shape)
        B = tok.shape[0]
        assert B == ref_tok.shape[0]
        _same(ref_sharding.cache_pspecs(ref_cache, ref_get_config(arch),
                                        ref_mesh, batch=B,
                                        kv_seq_shard=kv_seq_shard),
              ref_cache,
              sharding.cache_pspecs(cache, get_config(arch), mesh, batch=B,
                                    kv_seq_shard=kv_seq_shard),
              cache, mesh_name)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_specs_equal_the_reference(mesh_name, shape):
    ref_mesh, mesh = _meshes(mesh_name)
    for arch in ("qwen2_5_7b", "internvl2_26b", "whisper_tiny"):
        ref_cfg, cfg = ref_get_config(arch), get_config(arch)
        ref_kind, ref_in = ref_specs.input_specs(ref_cfg, shape)
        kind, inputs = specs.input_specs(cfg, shape)
        assert kind == ref_kind
        ref_b, b = ref_in["batch"], inputs["batch"]
        for batch_sharded in (True, False):
            _same(ref_sharding.batch_pspecs(ref_b, ref_cfg, ref_mesh,
                                            batch_sharded=batch_sharded),
                  ref_b,
                  sharding.batch_pspecs(b, cfg, mesh,
                                        batch_sharded=batch_sharded),
                  b, mesh_name)


def test_placements_put_pod_before_data():
    """("pod", "data") on one dim is Shard(i) on both mesh dims, in the
    mesh's order; another order, or an axis named twice, raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = sharding.MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert sharding.placements(sharding.P(("pod", "data"), None, "model"),
                               mesh) == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements(sharding.P(None, None), mesh) == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sharding.placements(sharding.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(sharding.P("data", "data"), mesh)
    assert sharding.dp_axes(mesh) == ("pod", "data")


@pytest.fixture
def fake_mesh_2x4():
    """A 2 x 4 ``DeviceMesh`` over a fake process group of 8 ranks, this
    process rank 0; the group is destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_mesh
    assert not dist.is_initialized()
    try:
        yield fake_mesh((2, 4), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_local_shapes_are_dtensors(fake_mesh_2x4):
    """The port's ``local_shape`` is the shape of rank 0's shard of a
    DTensor placed by ``to_named`` (``launch/dryrun.place``), on every leaf
    of the moe-with-MLA params and of a decode cache split along its
    keys."""
    from repro_torch.launch.dryrun import place
    mesh = fake_mesh_2x4
    cfg = get_config("deepseek_v2_236b")
    p = _params("deepseek_v2_236b")[1]
    cache, _, _, _ = specs.decode_specs(get_config("qwen2_5_7b"), "long_500k")
    for tree, spec in ((p, sharding.tree_pspecs(p, cfg, mesh)),
                       (cache, sharding.cache_pspecs(
                           cache, cfg, mesh, batch=1, kv_seq_shard=True))):
        spec = dict(sharding._with_paths(spec))
        for path, leaf in sharding._with_paths(tree):
            pl = sharding.placements(spec[path], mesh)
            dt = place(leaf, pl, mesh)
            assert dt.placements == pl
            assert tuple(dt.shape) == tuple(leaf.shape)
            assert tuple(dt.to_local().shape) == \
                sharding.local_shape(leaf.shape, pl, mesh)
            assert dt.to_local().device == torch.device("meta")
