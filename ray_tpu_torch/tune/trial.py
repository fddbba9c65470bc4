"""Trial: one hyperparameter configuration's lifecycle.

ray: python/ray/tune/experiment/trial.py:190 (Trial) — reduced to the fields
the runner/schedulers/persistence actually use.  Status FSM:
PENDING -> RUNNING -> {TERMINATED, ERROR, PAUSED} ; PAUSED -> PENDING
(PBT exploit restarts a paused trial with a mutated config + donor
checkpoint).
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclasses.dataclass
class Trial:
    config: Dict[str, Any]
    trial_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:8]
    )
    status: str = PENDING
    last_result: Optional[Dict[str, Any]] = None
    metrics_history: list = dataclasses.field(default_factory=list)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    num_failures: int = 0
    # iteration counter maintained by the runner (1 per report)
    training_iteration: int = 0
    # scheduler bookkeeping survives checkpoint/restore via __dict__ pickling
    stopped_early: bool = False
    # history/iteration high-water marks at the last checkpointed report —
    # a failure retry truncates back to these so resumed runs don't
    # duplicate steps in metrics_history
    ckpt_history_len: int = 0
    ckpt_training_iteration: int = 0

    def metric_value(self, metric: str) -> Optional[float]:
        if self.last_result is None:
            return None
        v = self.last_result.get(metric)
        return None if v is None else float(v)

    @property
    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR)

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status}, it={self.training_iteration})"
