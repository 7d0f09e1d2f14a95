"""Sharding rules: params / optimizer state / inputs -> partition specs, and
the specs as DTensor placements.

Scheme (Megatron-TP x FSDP, MaxText-style logical axes), as the
reference's:
  * "model" axis — tensor parallel: attention heads, FFN hidden, vocab,
    MoE experts (expert parallel when num_experts % model == 0, else
    tensor-parallel expert FFN), mamba/rglru channel dims.
  * "data" axis  — batch data parallel + FSDP weight sharding (params and
    optimizer state shard their d_model-ish dim over "data"; DTensor
    inserts the per-layer all-gathers).
  * "pod" axis   — pure data parallel across pods (multi-pod mesh);
    gradients all-reduce over it, parameters are NOT sharded over it.

Rules are path-pattern based so they cover every architecture in the zoo;
they are the reference's (``repro/distributed/sharding.py``) line for line.
A spec (``P``) names, for each tensor dim, ``None``, a mesh axis, or a
tuple of mesh axes, as a JAX ``PartitionSpec`` does. The rules read only a
mesh's axis names and sizes (``mesh.mesh_dim_names``, ``mesh.shape``), so
they take a ``DeviceMesh`` or a ``MeshShape``, which has no process group.
``to_named`` turns specs into DTensor placements, one per mesh dim.
"""
from __future__ import annotations

import math
import re
from typing import NamedTuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.training.train_state import TrainState


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, an axis
    name, or a tuple of axis names (major to minor)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class MeshShape(NamedTuple):
    """A mesh's axis sizes and names, without devices or ranks: what the
    rules read of a ``DeviceMesh``."""
    shape: tuple
    mesh_dim_names: tuple


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


def _div(n: int, mesh, axis: str) -> bool:
    sizes = _sizes(mesh)
    return axis in sizes and n % sizes[axis] == 0


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def param_spec(path: str, leaf, cfg, mesh) -> P:
    """path: "/"-joined tree path, e.g. "blocks/attn/wq/w"."""
    shape = leaf.shape
    stacked = bool(re.match(
        r"^(blocks|dense_blocks|tiles|enc_blocks|dec_blocks)(/|$)", path)) \
        and len(shape) >= 1
    lead: tuple = (None,) if stacked else ()

    def spec(*axes) -> P:
        # drop axis names that don't divide the corresponding dim
        ax = list(axes)
        off = len(lead)
        for i, a in enumerate(ax):
            if a is None:
                continue
            dim = shape[off + i] if off + i < len(shape) else 0
            if not _div(dim, mesh, a):
                ax[i] = None
        return P(*lead, *ax)

    # ---- embeddings / heads -------------------------------------------------
    if path.endswith("embed/table"):
        return spec("model", "data")
    if path.endswith("lm_head/w"):
        return spec("data", "model")
    if "enc_pos" in path or "dec_pos" in path:
        return spec(None, None)

    # ---- norms / scalars -----------------------------------------------------
    if "/ln" in path or "norm" in path or path.endswith("lambda") \
            or path.endswith("d_skip") or path.endswith("conv_b"):
        return spec(*([None] * (len(shape) - len(lead))))

    # ---- MoE -------------------------------------------------------------------
    if "/experts/" in path:  # (E, d, dff) or (E, dff, d)
        E = shape[len(lead)]
        if _div(E, mesh, "model"):
            return spec("model", None, None)          # expert parallel
        if path.endswith("down"):
            return spec(None, "model", "data")        # TP experts
        return spec(None, "data", "model")
    if "/router/" in path:
        return spec("data", None)
    if "/shared/" in path:
        if path.endswith("down/w"):
            return spec("model", "data")
        return spec("data", "model")

    # ---- MLA --------------------------------------------------------------------
    if path.endswith("w_dkv/w") or path.endswith("w_krope/w") \
            or path.endswith("w_dq/w"):
        return spec("data", None)
    if path.endswith("w_uk/w") or path.endswith("w_uv/w") \
            or path.endswith("w_uq/w"):
        return spec(None, "model")
    if path.endswith("w_q/w"):
        return spec("data", "model")

    # ---- attention -----------------------------------------------------------------
    if re.search(r"/(wq|wk|wv)/w$", path):
        return spec("data", "model")
    if re.search(r"/(wq|wk|wv)/b$", path):
        return spec("model")
    if path.endswith("wo/w"):
        return spec("model", "data")
    if path.endswith("wo/b"):
        return spec(None)

    # ---- MLP --------------------------------------------------------------------------
    if re.search(r"/(up|gate)/w$", path):
        return spec("data", "model")
    if path.endswith("down/w"):
        return spec("model", "data")

    # ---- mamba -------------------------------------------------------------------------
    if path.endswith("in_proj/w"):
        return spec("data", "model")
    if path.endswith("conv_w"):
        return spec(None, "model")
    if path.endswith("x_proj/w"):
        return spec("model", None)
    if path.endswith("dt_proj/w"):
        return spec(None, "model")
    if path.endswith("dt_proj/b"):
        return spec("model")
    if path.endswith("a_log"):
        return spec("model", None)
    if path.endswith("out_proj/w") or path.endswith("out/w"):
        return spec("model", "data")

    # ---- rglru ---------------------------------------------------------------------------
    if re.search(r"/(in_x|in_z)/w$", path):
        return spec("data", "model")
    if re.search(r"/(gate_a|gate_x)/w$", path):
        return spec(None, "model")

    # ---- fallback: replicate ----------------------------------------------------------------
    return spec(*([None] * (len(shape) - len(lead))))


def _with_paths(tree, prefix=""):
    """(path, leaf) of every leaf, in key order; paths join dict keys and
    list indices with "/", as the reference spells JAX's key paths; a
    spec (``P``) is a leaf."""
    if isinstance(tree, P):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [x for k, v in items
            for x in _with_paths(v, f"{prefix}/{k}" if prefix else str(k))]


def map_specs(fn, tree, *rest):
    """``fn`` over the leaves of a tree of specs or of tensors and the
    matching leaves of ``rest`` (trees of the same structure), ``P``
    being a leaf; dicts, lists, tuples and ``TrainState`` keep their
    type."""
    if isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [map_specs(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return TrainState(*kids) if isinstance(tree, TrainState) \
            else type(tree)(kids)
    return fn(tree, *rest)


def _rebuild(tree, leaves):
    it = iter(leaves)
    return map_specs(lambda _: next(it), tree)


def tree_pspecs(tree, cfg, mesh):
    """A tree of specs matching ``tree`` (params or a like-shaped
    optimizer-moment tree)."""
    return _rebuild(tree, [
        P() if leaf.dim() == 0 else param_spec(path, leaf, cfg, mesh)
        for path, leaf in _with_paths(tree)])


def state_pspecs(state, cfg, mesh):
    """Shardings for a TrainState(params, {"m","v","count"}, step)."""
    p = tree_pspecs(state.params, cfg, mesh)
    return TrainState(
        params=p,
        opt_state={"m": tree_pspecs(state.opt_state["m"], cfg, mesh),
                   "v": tree_pspecs(state.opt_state["v"], cfg, mesh),
                   "count": P()},
        step=P())


# ---------------------------------------------------------------------------
# input rules
# ---------------------------------------------------------------------------

def batch_pspecs(batch, cfg, mesh, *, batch_sharded=True):
    """Training/prefill batch: leading dim is global batch."""
    dp = dp_axes(mesh) if batch_sharded else None

    def one(k, leaf):
        nd = leaf.dim()
        if nd == 0:
            return P()
        return P(dp, *([None] * (nd - 1)))

    return {k: one(k, v) for k, v in batch.items()}


def cache_pspecs(cache, cfg, mesh, *, batch: int, kv_seq_shard: bool = False):
    """Decode KV/state caches. Layout conventions (leading layer axis):
      gqa  k/v      (L, B, S, kv, hd)
      mla  c_kv     (L, B, S, r), k_rope (L, B, S, dr)
      ssm  h        (L, B, di, ds), conv (L, B, kc-1, di)
      hybrid rec h  (Lr, B, w), conv (Lr, B, 3, w); att as gqa

    batch > 1  → B over dp axes; batch == 1 (long_500k) → the sequence dim
    (gqa/mla) shards over "data" instead.
    """
    dp = dp_axes(mesh)
    sizes = _sizes(mesh)
    b_ax = dp if batch > 1 and batch % math.prod(
        [sizes[a] for a in (dp if isinstance(dp, tuple) else (dp,))]
    ) == 0 else None

    def one(path, leaf):
        nd = leaf.dim()
        last = path.rsplit("/", 1)[-1]
        if last in ("k", "v") or "cross_" in path:
            # (L, B, S, kv, hd)
            kv = leaf.shape[3]
            kv_ax = "model" if _div(kv, mesh, "model") else None
            s_ax = "data" if (b_ax is None and
                              _div(leaf.shape[2], mesh, "data")) else None
            if kv_ax is None and kv_seq_shard and s_ax != "model" \
                    and _div(leaf.shape[2], mesh, "model"):
                s_ax = "model"   # flash-decode style seq sharding (HC3)
            return P(None, b_ax, s_ax, kv_ax, None)
        if path.endswith("c_kv") or path.endswith("k_rope"):
            s_ax = "data" if (b_ax is None and
                              _div(leaf.shape[2], mesh, "data")) else None
            if kv_seq_shard and s_ax is None \
                    and _div(leaf.shape[2], mesh, "model"):
                s_ax = "model"
            return P(None, b_ax, s_ax, None)
        if path.endswith("/h") or path == "h":
            if nd == 4:   # ssm (L,B,di,ds)
                return P(None, b_ax,
                         "model" if _div(leaf.shape[2], mesh, "model")
                         else None, None)
            return P(None, b_ax,
                     "model" if _div(leaf.shape[2], mesh, "model") else None)
        if path.endswith("conv"):
            return P(None, b_ax, None,
                     "model" if _div(leaf.shape[3], mesh, "model") else None)
        return P(*([None] * nd))

    return _rebuild(cache, [one(path, leaf)
                            for path, leaf in _with_paths(cache)])


# ---------------------------------------------------------------------------
# specs as DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec``: for each mesh dim, ``Shard(i)``
    where tensor dim ``i`` names its axis, else ``Replicate()``. A dim
    over several axes, ``("pod", "data")``, is ``Shard(i)`` on each of
    their mesh dims: DTensor splits a dim sharded on several mesh dims in
    mesh-dim order, the first the outermost, which is JAX's major-to-minor
    order when the spec names its axes in the mesh's order (the rules
    always do; another order raises)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        at = [names.index(a) for a in axes if a is not None]
        if at != sorted(at):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for j in at:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"spec {spec} names {names[j]!r} twice")
            out[j] = Shard(i)
    return tuple(out)


def to_named(tree_specs, mesh):
    """Each spec of ``tree_specs`` as its DTensor placements."""
    return map_specs(lambda s: placements(s, mesh), tree_specs)


def local_shape(shape, placements_, mesh) -> tuple:
    """The shape of rank 0's shard of a tensor of ``shape`` under
    ``placements_`` (DTensor's chunking: each ``Shard(i)`` on a mesh dim
    of size n leaves ``ceil(shape[i] / n)``, in mesh-dim order)."""
    out = list(shape)
    for n, pl in zip(mesh.shape, placements_):
        if isinstance(pl, Shard):
            out[pl.dim] = -(-out[pl.dim] // n)
    return tuple(out)
