"""TrialRunner: drives trials as actors over the ray_tpu_torch runtime.

ray: python/ray/tune/execution/trial_runner.py:583 (step loop) +
execution/ray_trial_executor.py:195 (trial actor lifecycle).  One actor per
live trial (max_concurrency=2: the trainable blocks one slot, poll() answers
in the other — the same pattern as train worker actors).  Schedulers return
CONTINUE/STOP/RESTART per report; RESTART (PBT exploit) relaunches the actor
with the mutated config + donor checkpoint.

Experiment state (trials, searcher, scheduler) is checkpointed to
<experiment_dir>/experiment_state.pkl after every transition, enabling
Tuner.restore after driver death (ray: tune/execution/experiment_state.py).
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.tune.schedulers import CONTINUE, RESTART, STOP, FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import Searcher
from ray_tpu_torch.tune.trial import ERROR, PAUSED, PENDING, RUNNING, TERMINATED, Trial


@ray_tpu_torch.remote(max_concurrency=2)
class _TrialActor:
    """Executes one trial's trainable; buffers tune session reports."""

    def __init__(self, trial_id: str):
        self.trial_id = trial_id
        self.session = None

    def run(self, trainable: Callable, config: Dict, resume_ckpt):
        from ray_tpu_torch.train.session import init_session

        self.session = init_session(
            rank=0,
            world_size=1,
            resume_checkpoint=resume_ckpt,
            experiment_name=self.trial_id,
        )
        try:
            import inspect

            sig = inspect.signature(trainable)
            if len(sig.parameters) == 0:
                trainable()
            else:
                trainable(config)
            self.session.done = True
            return {"ok": True}
        except BaseException:
            self.session.done = True
            raise

    def poll(self) -> Dict[str, Any]:
        if self.session is None:
            return {"reports": [], "done": False}
        return {"reports": self.session.drain(), "done": self.session.done}


class TrialRunner:
    def __init__(
        self,
        trainable: Callable,
        searcher: Searcher,
        scheduler: Optional[TrialScheduler],
        *,
        metric: str,
        mode: str = "max",
        max_concurrent: int = 4,
        resources_per_trial: Optional[Dict[str, float]] = None,
        max_failures: int = 0,
        stop: Optional[Dict[str, float]] = None,
        experiment_dir: str,
        trials: Optional[List[Trial]] = None,
        poll_interval: float = 0.05,
    ):
        self.trainable = trainable
        self.searcher = searcher
        self.scheduler = scheduler or FIFOScheduler()
        self.metric = metric
        self.mode = mode
        self.max_concurrent = max_concurrent
        self.resources = dict(resources_per_trial or {"CPU": 1.0})
        self.max_failures = max_failures
        self.stop = stop or {}
        self.experiment_dir = experiment_dir
        self.poll_interval = poll_interval
        self.trials: List[Trial] = trials or []
        self._actors: Dict[str, Any] = {}  # trial_id -> actor handle
        self._run_refs: Dict[str, Any] = {}  # trial_id -> run() ref
        # Refs of intentionally killed runs (STOP/RESTART).  Keyed by REF,
        # not trial id: a RESTART relaunches the same trial id immediately,
        # and a trial-id key would leak onto the new run and swallow its
        # real failures (hanging the whole experiment).
        self._killed_refs: List[Any] = []
        self._searcher_done = False
        self.searcher.set_search_properties(metric, mode)
        self.scheduler.set_search_properties(metric, mode)
        os.makedirs(experiment_dir, exist_ok=True)

    # -- main loop ---------------------------------------------------------
    def run(self) -> List[Trial]:
        self._fill_from_searcher()
        while not self._all_finished():
            self._start_pending()
            time.sleep(self.poll_interval)
            self._process_running()
            # Refill AFTER completions so model-based searchers (TPE) see
            # the finished trials' scores before suggesting the next batch
            # — draining suggest() upfront would degrade them to their
            # random warmup for the whole experiment
            # (ray: SearchGenerator queries the searcher incrementally).
            self._fill_from_searcher()
        self.checkpoint_experiment()
        return self.trials

    def _all_finished(self) -> bool:
        return (
            all(t.is_finished for t in self.trials)
            and not self._run_refs
            and self._searcher_done
        )

    def _fill_from_searcher(self):
        """Top the live/pending pool up to max_concurrent from the
        searcher; the rest of the budget stays with the searcher until
        capacity frees."""
        if self._searcher_done:
            return
        while (
            sum(1 for t in self.trials if not t.is_finished)
            < self.max_concurrent
        ):
            t = Trial(config={})
            cfg = self.searcher.suggest(t.trial_id)
            if cfg is None:
                self._searcher_done = True
                break
            t.config = cfg
            self.trials.append(t)

    def _live_count(self) -> int:
        return sum(1 for t in self.trials if t.status == RUNNING)

    def _start_pending(self):
        for t in self.trials:
            if t.status != PENDING:
                continue
            if self._live_count() >= self.max_concurrent:
                break
            self._launch(t)

    def _launch(self, t: Trial):
        res = dict(self.resources)
        opts: Dict[str, Any] = {"num_cpus": res.pop("CPU", 1.0)}
        if res:
            opts["resources"] = res
        actor = _TrialActor.options(**opts).remote(t.trial_id)
        ref = actor.run.remote(self.trainable, dict(t.config), t.checkpoint)
        self._actors[t.trial_id] = actor
        self._run_refs[t.trial_id] = ref
        t.status = RUNNING
        self.checkpoint_experiment()

    def _process_running(self):
        self._drain_killed_refs()
        running = [t for t in self.trials if t.status == RUNNING]
        if not running:
            return
        # Drain reports: fire every poll first so the RPCs run concurrently,
        # then gather — one slow/dying actor must not serialize the round.
        poll_refs = {}
        for t in running:
            try:
                poll_refs[t.trial_id] = self._actors[t.trial_id].poll.remote()
            except Exception:
                poll_refs[t.trial_id] = None
        polls = {}
        for tid, ref in poll_refs.items():
            try:
                polls[tid] = ray_tpu_torch.get(ref, timeout=30) if ref is not None else None
            except Exception:
                polls[tid] = None  # actor died; completion check below
        for t in running:
            p = polls.get(t.trial_id)
            if p:
                for rep in p["reports"]:
                    decision = self._handle_report(t, rep)
                    if decision != CONTINUE:
                        break
        # completion / crash via run refs
        done_pairs = [(tid, ref) for tid, ref in self._run_refs.items()]
        for tid, ref in done_pairs:
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
            if not ready:
                continue
            t = self._trial(tid)
            self._run_refs.pop(tid, None)
            try:
                ray_tpu_torch.get(ref, timeout=1)
                self._final_drain(t)
                if t.status == RUNNING:
                    self._finish(t, TERMINATED)
                self.searcher.on_trial_complete(tid, t.last_result, error=False)
                self.scheduler.on_trial_complete(t, t.last_result)
            except Exception as e:
                t.num_failures += 1
                if self.max_failures < 0 or t.num_failures <= self.max_failures:
                    self._cleanup_actor(tid)
                    # Drop the failed attempt's post-checkpoint reports so
                    # the resumed run doesn't duplicate steps in
                    # metrics_history (same contract as
                    # DataParallelTrainer's history truncation).
                    del t.metrics_history[t.ckpt_history_len :]
                    t.training_iteration = t.ckpt_training_iteration
                    t.last_result = (
                        t.metrics_history[-1] if t.metrics_history else None
                    )
                    t.status = PENDING  # retry from last checkpoint
                else:
                    t.error = repr(e)
                    self._finish(t, ERROR)
                    self.searcher.on_trial_complete(tid, t.last_result, error=True)
            self.checkpoint_experiment()

    def _drain_killed_refs(self):
        """Consume run refs of intentionally killed actors (their
        ActorDiedError is expected and must not be classified as a trial
        failure)."""
        still = []
        for ref in self._killed_refs:
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
            if not ready:
                still.append(ref)
                continue
            try:
                ray_tpu_torch.get(ref, timeout=1)
            except Exception:
                pass
        self._killed_refs = still

    def _final_drain(self, t: Trial):
        """A trainable may return between polls: drain reports buffered after
        the last poll round so last_result/checkpoint are never lost."""
        actor = self._actors.get(t.trial_id)
        if actor is None:
            return
        try:
            p = ray_tpu_torch.get(actor.poll.remote(), timeout=30)
        except Exception:
            return
        for rep in p["reports"]:
            self._handle_report(t, rep, final=True)

    def _handle_report(self, t: Trial, rep: Dict, final: bool = False) -> str:
        t.training_iteration += 1
        result = dict(rep["metrics"])
        result.setdefault("training_iteration", t.training_iteration)
        result["trial_id"] = t.trial_id
        result["config"] = dict(t.config)
        t.last_result = result
        t.metrics_history.append(result)
        if rep.get("checkpoint") is not None:
            t.checkpoint = rep["checkpoint"]
            t.ckpt_history_len = len(t.metrics_history)
            t.ckpt_training_iteration = t.training_iteration
        self.searcher.on_trial_result(t.trial_id, result)
        if final:
            # Trainable already returned: record only.  The scheduler is NOT
            # consulted — a PBT RESTART decision here would mutate
            # config/checkpoint (exploit from a donor) and then be discarded,
            # leaving the finished trial reporting a donor's checkpoint.
            return CONTINUE
        decision = self.scheduler.on_trial_result(t, result)
        if decision == CONTINUE and self._should_stop(result):
            decision = STOP
        if decision == STOP:
            self._kill(t.trial_id)
            t.stopped_early = True
            self._finish(t, TERMINATED)
            # Early-stopped trials complete too: searchers that learn from
            # outcomes (search.py plug-in seam) must see every completion.
            self.searcher.on_trial_complete(t.trial_id, t.last_result, error=False)
            self.scheduler.on_trial_complete(t, t.last_result)
        elif decision == RESTART:
            # PBT exploit: scheduler already mutated t.config/t.checkpoint
            self._kill(t.trial_id)
            t.status = PENDING
        return decision

    def _should_stop(self, result: Dict) -> bool:
        for key, threshold in self.stop.items():
            v = result.get(key)
            if v is None:
                continue
            if key == self.metric and self.mode == "min":
                if float(v) <= float(threshold):
                    return True
            elif float(v) >= float(threshold):
                return True
        return False

    # -- helpers -----------------------------------------------------------
    def _trial(self, tid: str) -> Trial:
        return next(t for t in self.trials if t.trial_id == tid)

    def _kill(self, tid: str):
        # Move the run ref out of the completion sweep's view: its eventual
        # ActorDiedError is expected, and a RESTART will reuse the trial id
        # for a fresh run ref immediately.
        ref = self._run_refs.pop(tid, None)
        if ref is not None:
            self._killed_refs.append(ref)
        self._cleanup_actor(tid)

    def _cleanup_actor(self, tid: str):
        actor = self._actors.pop(tid, None)
        if actor is not None:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
        # leave any _run_refs entry: the completion sweep consumes + classifies it

    def _finish(self, t: Trial, status: str):
        t.status = status
        self._cleanup_actor(t.trial_id)

    # -- persistence -------------------------------------------------------
    def checkpoint_experiment(self):
        state = {
            "trials": [self._trial_state(t) for t in self.trials],
            "searcher": self.searcher.save_state(),
            "scheduler": self.scheduler.save_state(),
            "metric": self.metric,
            "mode": self.mode,
        }
        tmp = os.path.join(self.experiment_dir, ".experiment_state.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, os.path.join(self.experiment_dir, "experiment_state.pkl"))

    def _trial_state(self, t: Trial) -> Dict:
        ckpt_path = None
        if t.checkpoint is not None:
            ckpt_path = os.path.join(self.experiment_dir, t.trial_id, "checkpoint")
            if t.checkpoint._dir is None or (
                os.path.abspath(t.checkpoint._dir) != os.path.abspath(ckpt_path)
            ):
                t.checkpoint.to_directory(ckpt_path)
                t.checkpoint = Checkpoint.from_directory(ckpt_path)
        return {
            "trial_id": t.trial_id,
            "config": t.config,
            "status": t.status,
            "last_result": t.last_result,
            "metrics_history": t.metrics_history,
            "error": t.error,
            "num_failures": t.num_failures,
            "training_iteration": t.training_iteration,
            "stopped_early": t.stopped_early,
            "checkpoint_path": ckpt_path,
        }

    @staticmethod
    def load_experiment(experiment_dir: str) -> Dict:
        with open(os.path.join(experiment_dir, "experiment_state.pkl"), "rb") as f:
            return pickle.load(f)

    @staticmethod
    def trials_from_state(state: Dict, *, restart_errored: bool = False) -> List[Trial]:
        trials = []
        for ts in state["trials"]:
            t = Trial(config=ts["config"], trial_id=ts["trial_id"])
            t.status = ts["status"]
            t.last_result = ts["last_result"]
            t.metrics_history = ts["metrics_history"] or []
            t.error = ts["error"]
            t.num_failures = ts["num_failures"]
            t.training_iteration = ts["training_iteration"]
            t.stopped_early = ts["stopped_early"]
            if ts["checkpoint_path"] and os.path.isdir(ts["checkpoint_path"]):
                t.checkpoint = Checkpoint.from_directory(ts["checkpoint_path"])
            if t.status in (RUNNING, PAUSED):
                t.status = PENDING  # was live when the driver died: resume
            if t.status == ERROR and restart_errored:
                t.status = PENDING
                t.error = None
                t.num_failures = 0
            trials.append(t)
        return trials
