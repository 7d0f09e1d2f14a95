from repro_torch.kernels.fused_rl_loss.ops import (fused_rl_loss,
                                                   fused_rl_loss_bwd,
                                                   fused_rl_loss_fwd)
from repro_torch.kernels.fused_rl_loss.ref import (fused_rl_loss_bwd_ref,
                                                   fused_rl_loss_bwd_tolerance,
                                                   fused_rl_loss_fwd_ref,
                                                   fused_rl_loss_oracle)

__all__ = ["fused_rl_loss", "fused_rl_loss_bwd", "fused_rl_loss_bwd_ref",
           "fused_rl_loss_bwd_tolerance", "fused_rl_loss_fwd",
           "fused_rl_loss_fwd_ref", "fused_rl_loss_oracle"]
