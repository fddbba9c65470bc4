"""Trial schedulers: FIFO, ASHA early stopping, Population Based Training.

ray: python/ray/tune/schedulers/trial_scheduler.py (decision protocol),
async_hyperband.py (AsyncHyperBandScheduler/ASHA), pbt.py
(PopulationBasedTraining).  Differences by design: our function trainables
cannot pause in place, so PBT's exploit is expressed as a RESTART decision —
the runner kills the trial actor and relaunches it with the mutated config
and the donor's checkpoint (the reference does the same for function
trainables via checkpoint+restore).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.trial import Trial

CONTINUE = "CONTINUE"
STOP = "STOP"
RESTART = "RESTART"  # PBT exploit: relaunch with trial.config/trial.checkpoint


class TrialScheduler:
    def set_search_properties(self, metric: str, mode: str):
        self.metric = metric
        self.mode = mode

    def _score(self, result: Dict) -> Optional[float]:
        v = result.get(self.metric)
        if v is None:
            return None
        v = float(v)
        return v if self.mode == "max" else -v

    def on_trial_result(self, trial: Trial, result: Dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial: Trial, result: Optional[Dict]):
        pass

    def save_state(self) -> Dict:
        return dict(self.__dict__)

    def restore_state(self, state: Dict):
        self.__dict__.update(state)


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (ray: trial_scheduler.py FIFOScheduler)."""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (ray: tune/schedulers/async_hyperband.py).

    Rungs at grace_period * reduction_factor^k.  When a trial reports at or
    past a rung it hasn't been judged at, its metric is recorded; if it falls
    outside the top 1/reduction_factor of everything recorded at that rung,
    it is stopped.  Asynchronous: no waiting for a full bracket.
    """

    def __init__(
        self,
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        reduction_factor: float = 3,
        max_t: int = 100,
        brackets: int = 1,
    ):
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        # rung milestones (ascending), excluding max_t itself
        self.milestones: List[int] = []
        t = grace_period
        while t < max_t:
            self.milestones.append(int(t))
            t *= reduction_factor
        # rung -> {trial_id: score}
        self.rungs: Dict[int, Dict[str, float]] = {m: {} for m in self.milestones}

    def on_trial_result(self, trial: Trial, result: Dict) -> str:
        t = result.get(self.time_attr)
        score = self._score(result)
        if t is None or score is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP  # budget exhausted (normal completion, not demotion)
        decision = CONTINUE
        for m in self.milestones:
            if t < m:
                break
            rung = self.rungs[m]
            if trial.trial_id in rung:
                continue
            rung[trial.trial_id] = score
            if len(rung) > 1:
                cutoff_idx = max(0, int(len(rung) / self.rf) - 1)
                cutoff = sorted(rung.values(), reverse=True)[cutoff_idx]
                if score < cutoff:
                    decision = STOP
        return decision


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running best is below the median of completed
    averages at the same step (ray: tune/schedulers/median_stopping_rule.py)."""

    def __init__(self, time_attr: str = "training_iteration", grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._avgs: Dict[str, List[float]] = {}

    def on_trial_result(self, trial: Trial, result: Dict) -> str:
        t = result.get(self.time_attr)
        score = self._score(result)
        if t is None or score is None or t < self.grace_period:
            return CONTINUE
        hist = self._avgs.setdefault(trial.trial_id, [])
        hist.append(score)
        others = [sum(v) / len(v) for k, v in self._avgs.items() if k != trial.trial_id]
        if len(others) < self.min_samples:
            return CONTINUE
        median = sorted(others)[len(others) // 2]
        best = max(hist)
        return STOP if best < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (ray: tune/schedulers/pbt.py).

    Every perturbation_interval steps a trial's score is recorded.  Trials in
    the bottom quantile exploit a random top-quantile donor: copy its latest
    checkpoint, mutate the donor's hyperparameters (x0.8 / x1.2 for numeric,
    resample for categorical), and RESTART.
    """

    def __init__(
        self,
        time_attr: str = "training_iteration",
        perturbation_interval: int = 5,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
    ):
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}
        # trial_id -> (config, checkpoint) of latest exploitable state
        self._states: Dict[str, tuple] = {}
        self.num_perturbations = 0

    def on_trial_result(self, trial: Trial, result: Dict) -> str:
        t = result.get(self.time_attr)
        score = self._score(result)
        if t is None or score is None:
            return CONTINUE
        self._scores[trial.trial_id] = score
        self._states[trial.trial_id] = (dict(trial.config), trial.checkpoint)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        ranked = sorted(self._scores.items(), key=lambda kv: kv[1])
        n = len(ranked)
        if n < 2:
            return CONTINUE
        k = max(1, int(n * self.quantile))
        bottom = {tid for tid, _ in ranked[:k]}
        top = [tid for tid, _ in ranked[-k:]]
        if trial.trial_id not in bottom:
            return CONTINUE
        donor_id = self.rng.choice([tid for tid in top if tid != trial.trial_id] or top)
        donor_cfg, donor_ckpt = self._states.get(donor_id, (None, None))
        if donor_cfg is None:
            return CONTINUE
        # exploit + explore: mutate the donor's config in place on the trial
        new_cfg = dict(trial.config)
        new_cfg.update(donor_cfg)
        new_cfg = self._explore(new_cfg)
        trial.config = new_cfg
        if donor_ckpt is not None:
            trial.checkpoint = donor_ckpt
        self.num_perturbations += 1
        return RESTART

    def _explore(self, cfg: Dict) -> Dict:
        """Perturb an exploited config (hook: PB2 replaces this with a
        GP-bandit choice for its bounded params)."""
        for key, spec in self.mutations.items():
            cfg[key] = self._mutate(cfg.get(key), spec)
        return cfg

    def _mutate(self, current, spec):
        from ray_tpu_torch.tune.search import Domain

        if isinstance(spec, list):
            if current not in spec or self.rng.random() < self.resample_prob:
                return self.rng.choice(spec)
            i = spec.index(current)
            j = min(len(spec) - 1, max(0, i + self.rng.choice([-1, 1])))
            return spec[j]
        if isinstance(spec, Domain):
            return spec.sample(self.rng)
        if callable(spec):
            return spec()
        if isinstance(current, (int, float)):
            factor = self.rng.choice([0.8, 1.2])
            out = current * factor
            return int(out) if isinstance(current, int) else out
        return current

    def save_state(self) -> Dict:
        d = dict(self.__dict__)
        d["rng"] = self.rng.getstate()
        return d

    def restore_state(self, state: Dict):
        rng_state = state.pop("rng", None)
        self.__dict__.update(state)
        self.rng = random.Random()
        if rng_state is not None:
            self.rng.setstate(rng_state)


class PB2(PopulationBasedTraining):
    """PBT with GP-bandit exploration (ray: tune/schedulers/pb2.py).

    Exploit is inherited from PBT (bottom-quantile trials copy a top
    donor's checkpoint); EXPLORE replaces random mutation for bounded
    continuous hyperparams with a Gaussian-process UCB choice fit to
    (hyperparams -> score improvement) history — sample-efficient tuning
    when perturbation budgets are small.  Unbounded/categorical params
    still mutate the PBT way.
    """

    def __init__(
        self,
        time_attr: str = "training_iteration",
        perturbation_interval: int = 5,
        hyperparam_bounds: Optional[Dict[str, tuple]] = None,
        quantile_fraction: float = 0.25,
        ucb_kappa: float = 1.5,
        n_candidates: int = 256,
        seed: Optional[int] = None,
        **kw,
    ):
        super().__init__(
            time_attr=time_attr,
            perturbation_interval=perturbation_interval,
            quantile_fraction=quantile_fraction,
            seed=seed,
            **kw,
        )
        self.bounds = dict(hyperparam_bounds or {})
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        # (hyperparam vector, score delta over the interval) observations
        self._gp_data: list = []
        self._prev_score: Dict[str, float] = {}

    def on_trial_result(self, trial: Trial, result: Dict) -> str:
        score = self._score(result)
        t = result.get(self.time_attr)
        if score is not None and t is not None and self.bounds:
            prev = self._prev_score.get(trial.trial_id)
            if prev is not None:
                x = [float(trial.config.get(k, 0.0)) for k in sorted(self.bounds)]
                self._gp_data.append((x, score - prev))
                self._gp_data = self._gp_data[-256:]
            self._prev_score[trial.trial_id] = score
        decision = super().on_trial_result(trial, result)
        if decision == RESTART:
            # The exploit copies a donor checkpoint: the next report's
            # score jump is the COPY, not the new hyperparams' doing —
            # recording that delta would teach the GP a fiction.
            self._prev_score.pop(trial.trial_id, None)
        return decision

    def _explore(self, cfg: Dict) -> Dict:
        cfg = super()._explore(cfg)  # PBT mutation for non-bounded keys
        return self._explore_config(cfg)

    def _gp_choose(self) -> Optional[Dict[str, float]]:
        if len(self._gp_data) < 4:
            return None
        try:
            import numpy as np
            from sklearn.gaussian_process import GaussianProcessRegressor
            from sklearn.gaussian_process.kernels import Matern
        except Exception:
            return None
        keys = sorted(self.bounds)
        X = np.array([x for x, _ in self._gp_data])
        y = np.array([d for _, d in self._gp_data])
        y = (y - y.mean()) / (y.std() + 1e-9)
        lo = np.array([self.bounds[k][0] for k in keys], dtype=float)
        hi = np.array([self.bounds[k][1] for k in keys], dtype=float)
        span = hi - lo
        gp = GaussianProcessRegressor(
            # The GP sees [0,1]-normalized inputs, so the length scale is
            # in NORMALIZED units — span-scaled values would flatten (or
            # shatter) the kernel and degrade UCB to a random pick.
            kernel=Matern(nu=2.5, length_scale=0.25),
            alpha=1e-3,
            normalize_y=False,
        )
        try:
            gp.fit((X - lo) / span, y)
        except Exception:
            return None
        rngs = np.random.default_rng(self.rng.randrange(1 << 31))
        cand = rngs.uniform(size=(self.n_candidates, len(keys)))
        mu, sigma = gp.predict(cand, return_std=True)
        best = cand[int(np.argmax(mu + self.kappa * sigma))]
        chosen = lo + best * span
        return dict(zip(keys, chosen.tolist()))

    def _explore_config(self, cfg: Dict) -> Dict:
        gp_pick = self._gp_choose()
        for key in self.bounds:
            if gp_pick is not None:
                cfg[key] = gp_pick[key]
            else:
                lo, hi = self.bounds[key]
                cfg[key] = self.rng.uniform(lo, hi)
        return cfg

    # save/restore: PBT serializes __dict__ wholesale, which already
    # covers _gp_data/_prev_score/bounds — no override needed.
