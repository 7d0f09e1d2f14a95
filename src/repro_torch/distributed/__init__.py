"""Multi-rank execution on ``torch.distributed``: the sharded flash-decode
combine and expert-parallel MoE. Importing this package starts no
process group; the caller starts one (``torchrun``, or
``init_process_group`` with a store) and builds its ``DeviceMesh``
(``launch/mesh.py``)."""
from repro_torch.distributed.expert_parallel import ep_moe_ffn
from repro_torch.distributed.flash_decode import (partial_decode_combine,
                                                  sharded_decode_attention)

__all__ = ["sharded_decode_attention", "partial_decode_combine",
           "ep_moe_ffn"]
