"""TrainState: params + prox-optimizer state + debias mask (port of
``repro.train.state``). ``step`` is a host int."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core.optimizers import ProxOptimizer, ProxState

PyTree = Any


@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt_state: ProxState
    mask: Optional[PyTree]      # debias mask (None until retraining)
    step: int

    @classmethod
    def create(cls, params: PyTree, opt: ProxOptimizer,
               mask: Optional[PyTree] = None) -> "TrainState":
        return cls(params=params, opt_state=opt.init(params), mask=mask,
                   step=0)
