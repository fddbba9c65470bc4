"""SampleBatch: columnar rollout container, the port's copy of
`ray_tpu/rllib/sample_batch.py` (numpy only; the port imports nothing of
`ray_tpu`).

ray: rllib/policy/sample_batch.py (SampleBatch / concat_samples) — reduced
to a dict of numpy arrays with the standard column names.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
LOGPS = "action_logp"
VALUES = "vf_preds"
ADVANTAGES = "advantages"
RETURNS = "value_targets"


class SampleBatch(dict):
    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch(
            {k: np.concatenate([np.asarray(b[k]) for b in batches]) for k in keys}
        )

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = self.count
        for i in range(0, n - size + 1, size):
            yield SampleBatch({k: np.asarray(v)[i : i + size] for k, v in self.items()})


def compute_gae(
    rewards: np.ndarray,
    values: np.ndarray,
    dones: np.ndarray,
    bootstrap_value: np.ndarray,
    gamma: float = 0.99,
    lam: float = 0.95,
):
    """Generalized advantage estimation over a [T, N] rollout
    (ray: rllib/evaluation/postprocessing.py compute_gae_for_sample_batch).

    Vectorized across the env axis; the time recursion runs backward in
    numpy on the host — rollout post-processing is not the hot loop, the
    learner's update is."""
    T, N = rewards.shape
    adv = np.zeros((T, N), dtype=np.float32)
    lastgaelam = np.zeros(N, dtype=np.float32)
    for t in reversed(range(T)):
        nextvalue = bootstrap_value if t == T - 1 else values[t + 1]
        nonterminal = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * nextvalue * nonterminal - values[t]
        lastgaelam = delta + gamma * lam * nonterminal * lastgaelam
        adv[t] = lastgaelam
    returns = adv + values
    return adv, returns
