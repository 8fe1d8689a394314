"""The training state: the counterpart of the JAX package's ``TrainState``.

The port's model owns its params and the optimizer owns its moments, both
updated in place; the state ties them to the step counter (the
optimizer-update count the schedule reads). Loss scaling (``DynamicScale``)
is not ported: ``config.refuse_unported`` refuses ``precision.loss_scale``.
"""

from __future__ import annotations

import dataclasses

from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    tx: object  # optim.AdamW
    schedule: object  # count -> lr
