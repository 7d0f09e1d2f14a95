from repro_torch.models.model import (count_params, decode_step, forward,
                                      init_cache, init_params)

__all__ = ["init_params", "forward", "decode_step", "init_cache",
           "count_params"]
