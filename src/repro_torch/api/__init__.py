from repro_torch.api.service import AsyncFlowService
from repro_torch.api.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "AsyncFlowService"]
