from repro_torch.api.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
