"""Backend-level interface (paper §5.2, Code 2).

``RLAdapter`` is the low-level abstraction of RL tasks: each backend
(our JAX engines here; MindSpeed/vLLM/FSDP in the paper) implements the
same task verbs, so the algorithm layer never touches engine internals.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, List


class RLAdapter(abc.ABC):
    """Abstraction of RL tasks over a training/inference backend."""

    # -- inference-side tasks -------------------------------------------------
    def generate_sequences(self, prompts: List[Any], **kw):
        raise NotImplementedError

    def compute_log_prob(self, batch: Dict[str, Any], **kw):
        raise NotImplementedError

    def compute_values(self, batch: Dict[str, Any], **kw):
        raise NotImplementedError

    def compute_rewards(self, batch: Dict[str, Any], **kw):
        raise NotImplementedError

    # -- training-side tasks ---------------------------------------------------
    def update_actor(self, batch: Dict[str, Any], **kw):
        raise NotImplementedError

    def update_critic(self, batch: Dict[str, Any], **kw):
        raise NotImplementedError

    # -- weights ---------------------------------------------------------------
    def get_weights(self):
        raise NotImplementedError

    def load_weights(self, weights) -> None:
        raise NotImplementedError


class EngineRegistry:
    """Engine plug-in point: industrial users register custom backends
    without touching the algorithm layer (paper §5)."""

    _registry: Dict[str, type] = {}

    @classmethod
    def register(cls, name: str):
        def deco(klass):
            cls._registry[name] = klass
            return klass
        return deco

    @classmethod
    def create(cls, name: str, *a, **kw) -> RLAdapter:
        if name not in cls._registry:
            raise KeyError(f"unknown engine {name!r}; "
                           f"registered: {list(cls._registry)}")
        return cls._registry[name](*a, **kw)
