"""Multi-rank execution on ``torch.distributed``: the sharded flash-decode
combine and expert-parallel MoE. The sharding rules (``sharding.py``) map
params, optimizer state and inputs to partition specs and DTensor
placements. Importing this package starts no process group; the caller
starts one (``torchrun``, or ``init_process_group`` with a store) and
builds its ``DeviceMesh`` (``launch/mesh.py``)."""
from repro_torch.distributed.expert_parallel import ep_moe_ffn
from repro_torch.distributed.flash_decode import (partial_decode_combine,
                                                  sharded_decode_attention)
from repro_torch.distributed.sharding import (batch_pspecs, cache_pspecs,
                                              dp_axes, param_spec,
                                              state_pspecs, to_named,
                                              tree_pspecs)

__all__ = ["sharded_decode_attention", "partial_decode_combine",
           "ep_moe_ffn", "param_spec", "tree_pspecs", "state_pspecs",
           "batch_pspecs", "cache_pspecs", "to_named", "dp_axes"]
