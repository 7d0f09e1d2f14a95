from repro_torch.models.model import (count_params, decode_step,
                                      decode_window, forward, init_cache,
                                      init_params)

__all__ = ["init_params", "forward", "decode_step", "init_cache",
           "decode_window", "count_params"]
