from repro_torch.engines.adapter import EngineRegistry, RLAdapter
from repro_torch.engines.rollout_engine import RolloutEngine
from repro_torch.engines.train_engine import (CriticEngine, TrainEngine,
                                              pack_rows)

__all__ = ["RLAdapter", "EngineRegistry", "RolloutEngine", "TrainEngine",
           "CriticEngine", "pack_rows"]
