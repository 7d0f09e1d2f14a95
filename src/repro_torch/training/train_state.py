"""TrainState — params + optimizer state + step counter."""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.training.optimizer import (OptimizerConfig, adamw_update,
                                            init_opt_state)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int

    @classmethod
    def create(cls, params):
        return cls(params, init_opt_state(params), 0)

    def apply_gradients(self, grads, opt_cfg: OptimizerConfig):
        """The next state and the grad norm. New parameter tensors; the
        moments are updated in place, so the old state's ``opt_state`` is
        the new one's (see ``optimizer.py``)."""
        new_params, new_opt, gnorm = adamw_update(
            self.params, grads, self.opt_state, opt_cfg)
        return self._replace(params=new_params, opt_state=new_opt,
                             step=self.step + 1), gnorm
