"""Tuner: the user-facing entry point.

ray: python/ray/tune/tuner.py:47 (Tuner, fit :327) + tune/result_grid.py.
Accepts a function trainable or a DataParallelTrainer (the trainer runs
inside the trial actor and spawns its own SPMD worker group — nested actor
creation, the TPU analogue of the reference wrapping trainers in trainables
at base_trainer.py:538).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trial import ERROR, TERMINATED, Trial
from ray_tpu_torch.tune.trial_runner import TrialRunner


@dataclasses.dataclass
class TuneConfig:
    """ray: python/ray/tune/tune_config.py."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    resources_per_trial: Optional[Dict[str, float]] = None
    seed: Optional[int] = None


class ResultGrid:
    """ray: python/ray/tune/result_grid.py."""

    def __init__(self, trials: List[Trial], metric: str, mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._trials)

    def __getitem__(self, i) -> Result:
        return self._to_result(self._trials[i])

    def _to_result(self, t: Trial) -> Result:
        err = RuntimeError(t.error) if t.error else None
        return Result(
            metrics=t.last_result,
            checkpoint=t.checkpoint,
            error=err,
            metrics_history=t.metrics_history,
        )

    @property
    def trials(self) -> List[Trial]:
        return self._trials

    @property
    def errors(self) -> List[Result]:
        return [self._to_result(t) for t in self._trials if t.status == ERROR]

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [
            t for t in self._trials if t.last_result and t.last_result.get(metric) is not None
        ]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        best = (max if mode == "max" else min)(
            scored, key=lambda t: float(t.last_result[metric])
        )
        return self._to_result(best)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([t.last_result or {} for t in self._trials])


def _as_trainable(trainable) -> Callable:
    """Function trainables pass through; trainers wrap into one."""
    from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer

    if isinstance(trainable, DataParallelTrainer):
        trainer = trainable

        def trainer_trainable(config: Dict[str, Any]):
            import copy

            t = copy.copy(trainer)
            tlc = dict(t.train_loop_config or {})
            overrides = config.get("train_loop_config")
            if overrides:
                tlc.update(overrides)
            else:
                # flat param spaces map straight into the train loop config
                tlc.update({k: v for k, v in config.items() if k != "scaling_config"})
            t.train_loop_config = tlc
            if "scaling_config" in config:
                t.scaling_config = config["scaling_config"]
            from ray_tpu_torch.train.session import get_checkpoint

            t.resume_from_checkpoint = get_checkpoint() or t.resume_from_checkpoint
            result = t.fit()
            if result.error is not None:
                raise result.error

        return trainer_trainable
    if callable(trainable):
        return trainable
    raise TypeError(f"trainable must be callable or a trainer, got {type(trainable)}")


class Tuner:
    def __init__(
        self,
        trainable,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        _trials: Optional[List[Trial]] = None,
    ):
        self._orig_trainable = trainable
        self._trainable = _as_trainable(trainable)
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._restored_trials = _trials

    def _experiment_dir(self) -> str:
        rc = self._run_config
        base = rc.storage_path or os.path.join(tempfile.gettempdir(), "ray_tpu_results")
        name = rc.name or "tune_experiment"
        return os.path.join(base, name)

    def fit(self) -> ResultGrid:
        import ray_tpu_torch

        ray_tpu_torch._auto_init()
        tc = self._tune_config
        metric = tc.metric or "_metric"
        searcher = tc.search_alg or BasicVariantGenerator(
            self._param_space, num_samples=tc.num_samples, seed=tc.seed
        )
        if self._restored_trials is not None:
            # searcher already exhausted in the original run
            searcher = _ExhaustedSearcher()
        max_concurrent = tc.max_concurrent_trials
        if max_concurrent is None:
            try:
                cpus = ray_tpu_torch.cluster_resources().get("CPU", 4.0)
            except Exception:
                cpus = 4.0
            per = (tc.resources_per_trial or {"CPU": 1.0}).get("CPU", 1.0) or 1.0
            # A trainer trainable spawns nested worker actors from inside
            # the trial; their CPUs must count against per-trial demand or
            # the trial actors alone saturate the cluster and the nested
            # workers deadlock in the scheduler queue.
            from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer

            if isinstance(self._orig_trainable, DataParallelTrainer):
                sc = self._orig_trainable.scaling_config
                if sc is not None:
                    per += sc.num_workers * sc.worker_resources().get("CPU", 1.0)
            max_concurrent = max(1, int(cpus // per))
        failure_cfg = self._run_config.failure_config
        runner = TrialRunner(
            self._trainable,
            searcher,
            tc.scheduler,
            metric=metric,
            mode=tc.mode,
            max_concurrent=max_concurrent,
            resources_per_trial=tc.resources_per_trial,
            max_failures=failure_cfg.max_failures if failure_cfg else 0,
            stop=getattr(self._run_config, "stop", None),
            experiment_dir=self._experiment_dir(),
            trials=self._restored_trials,
        )
        trials = runner.run()
        return ResultGrid(trials, metric, tc.mode)

    @classmethod
    def restore(
        cls,
        path: str,
        trainable,
        *,
        restart_errored: bool = False,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ) -> "Tuner":
        """Rebuild a Tuner from <experiment_dir> after driver death
        (ray: tuner.py Tuner.restore)."""
        state = TrialRunner.load_experiment(path)
        trials = TrialRunner.trials_from_state(state, restart_errored=restart_errored)
        tc = tune_config or TuneConfig()
        tc.metric = tc.metric or state.get("metric")
        tc.mode = state.get("mode", tc.mode)
        rc = run_config or RunConfig()
        rc.storage_path = rc.storage_path or os.path.dirname(path)
        rc.name = rc.name or os.path.basename(path)
        return cls(
            trainable,
            param_space=param_space,
            tune_config=tc,
            run_config=rc,
            _trials=trials,
        )


class _ExhaustedSearcher(Searcher):
    def suggest(self, trial_id: str):
        return None


def run(
    trainable,
    *,
    config: Optional[Dict[str, Any]] = None,
    metric: Optional[str] = None,
    mode: str = "max",
    num_samples: int = 1,
    scheduler: Optional[TrialScheduler] = None,
    stop: Optional[Dict[str, float]] = None,
    **kwargs,
) -> ResultGrid:
    """Legacy convenience API (ray: python/ray/tune/tune.py tune.run)."""
    rc = RunConfig()
    if stop is not None:
        rc.stop = stop
    tuner = Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric, mode=mode, num_samples=num_samples, scheduler=scheduler,
            **{k: v for k, v in kwargs.items() if k in TuneConfig.__dataclass_fields__},
        ),
        run_config=rc,
    )
    return tuner.fit()
