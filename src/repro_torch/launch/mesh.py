"""Device meshes on ``torch.distributed``.

Functions, not module-level constants, so importing touches no process
group. Each returns a ``DeviceMesh`` from ``init_device_mesh`` over the
default process group, which the caller starts first with a world of the
mesh's size: ``torchrun``, or ``init_process_group`` with a store. Single
pod: 16 x 16 = 256 cards (data x model); multi-pod: 2 x 16 x 16 = 512
with a leading pure-DP "pod" axis.
"""
from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.device import resolve_device


def production_shape(*, multi_pod: bool = False):
    """(sizes, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    shape, axes = production_shape(multi_pod=multi_pod)
    return init_device_mesh(resolve_device(None).type, shape,
                            mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, pod: int = 0,
                    device_type=None):
    """A small mesh: gloo ranks on the CPU (``device_type="cpu"``), or
    the one card's 1 x 1 mesh (``cuda``, the default)."""
    dev = resolve_device(device_type).type
    if pod:
        return init_device_mesh(dev, (pod, n_data, n_model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(dev, (n_data, n_model),
                            mesh_dim_names=("data", "model"))
