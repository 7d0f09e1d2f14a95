"""input_specs — meta-tensor stand-ins for every model input (shardable,
zero allocation), as the reference's ``ShapeDtypeStruct``s.

One entry point per step kind; shapes come from the assigned INPUT_SHAPES
table. Audio/VLM modality frontends are stubs: ``frames`` /
``vision_embeds`` arrive as precomputed embeddings of the right shape.
Token ids and positions are int64 where the reference's are int32: the
port's embedding gather and its loss kernels take int64 ids. The other
dtypes are the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.models import init_cache, init_params
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import decode_window
from repro_torch.training.train_state import TrainState

META = torch.device("meta")


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def params_struct(cfg):
    return init_params(0, cfg, device=META)


def state_struct(cfg):
    return TrainState.create(params_struct(cfg))


def _modality(batch, cfg, B):
    cd = dtype_of(cfg.compute_dtype)
    if cfg.arch_type == "audio":
        batch["frames"] = _sds((B, cfg.encoder_frames, cfg.d_model), cd)
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = _sds((B, cfg.vision_tokens, cfg.d_model), cd)
    return batch


def train_specs(cfg, shape_name: str = "train_4k"):
    shp = INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    batch = {
        "tokens": _sds((B, S), torch.int64),
        "response_mask": _sds((B, S), torch.float32),
        "old_logprob": _sds((B, S), torch.float32),
        "advantage": _sds((B,), torch.float32),
    }
    return _modality(batch, cfg, B)


def prefill_specs(cfg, shape_name: str = "prefill_32k"):
    shp = INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    return _modality({"tokens": _sds((B, S), torch.int64)}, cfg, B)


def decode_specs(cfg, shape_name: str):
    """(cache, token, pos, ring); cache length follows decode_window
    (sliding-window ring for dense long_500k)."""
    B = INPUT_SHAPES[shape_name].global_batch
    length, ring = decode_window(cfg, shape_name)
    cache = init_cache(cfg, B, length, device=META)
    return cache, _sds((B,), torch.int64), _sds((B,), torch.int64), ring


def input_specs(cfg, shape_name: str):
    """Unified: returns (kind, specs_dict)."""
    kind = INPUT_SHAPES[shape_name].kind
    if kind == "train":
        return kind, {"batch": train_specs(cfg, shape_name)}
    if kind == "prefill":
        return kind, {"batch": prefill_specs(cfg, shape_name)}
    cache, token, pos, ring = decode_specs(cfg, shape_name)
    return kind, {"cache": cache, "token": token, "pos": pos, "ring": ring}
