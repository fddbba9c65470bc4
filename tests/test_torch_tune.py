"""The port's tune (`ray_tpu_torch.tune`, a copy of `ray_tpu/tune/`):
searchers, ASHA early stopping, PBT and PB2, failure retry, experiment
restore, and a Tuner over the port's TorchTrainer.

tests/test_tune.py's cases run on the port; its Tuner over JaxTrainer
becomes a Tuner over `ray_tpu_torch.train.torch.TorchTrainer` on CPU
workers. From the same seeds the port's searchers and schedulers make the
JAX package's choices exactly (both in this process, no runtime). Two
trials that each ask for one "GPU" hold distinct card ids, and trials whose
trainer workers need every "GPU" take them in turn. One port runtime
serves the file, with 4 CPUs (the source's fixture starts 8; no case here
needs more than 4) and 2 "GPU"s, which no card backs: only the card cases
ask for them. The trainables are defined inside the tests
and pickled by value; this module imports jax and ray_tpu only inside
functions.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import FailureConfig, RunConfig


@pytest.fixture(scope="module", autouse=True)
def rt():
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 2})
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def tune_cluster(tmp_path):
    return str(tmp_path)


def test_grid_and_random_search(tune_cluster):
    def trainable(config):
        tune.report({"score": config["a"] * 10 + config["b"]})

    tuner = tune.Tuner(
        trainable,
        param_space={"a": tune.grid_search([1, 2, 3]), "b": tune.uniform(0, 1)},
        tune_config=tune.TuneConfig(metric="score", mode="max", seed=7),
        run_config=RunConfig(name="grid", storage_path=tune_cluster),
    )
    results = tuner.fit()
    assert len(results) == 3
    best = results.get_best_result()
    assert best.metrics["config"]["a"] == 3
    df_scores = sorted(r["score"] // 10 for r in [t.last_result for t in results.trials])
    assert df_scores == [1, 2, 3]


def test_asha_stops_bad_trials(tune_cluster):
    def trainable(config):
        for step in range(1, 21):
            # lr quality is baked into the score slope
            tune.report({"score": config["lr"] * step, "training_iteration": step})

    # Serial execution, best-first order: ASHA's rungs retain completed
    # trials' scores, so the later bad trials deterministically fall below
    # the recorded cutoffs (tests/test_tune.py's reasoning).
    tuner = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([10.0, 1.0, 0.1, 0.01])},
        tune_config=tune.TuneConfig(
            metric="score",
            mode="max",
            max_concurrent_trials=1,
            scheduler=tune.ASHAScheduler(grace_period=2, reduction_factor=2, max_t=20),
        ),
        run_config=RunConfig(name="asha", storage_path=tune_cluster),
    )
    results = tuner.fit()
    trials = results.trials
    assert len(trials) == 4
    stopped = [t for t in trials if t.stopped_early and t.training_iteration < 20]
    assert stopped, "ASHA should stop at least one underperforming trial early"
    best = results.get_best_result()
    assert best.metrics["config"]["lr"] == 10.0


def test_stop_criteria_and_checkpoint(tune_cluster):
    def trainable(config):
        ckpt = tune.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt else 0
        for step in range(start, 100):
            tune.report(
                {"step": step}, checkpoint=Checkpoint.from_dict({"step": step})
            )

    tuner = tune.Tuner(
        trainable,
        param_space={},
        tune_config=tune.TuneConfig(metric="step", mode="max"),
        run_config=RunConfig(name="stopper", storage_path=tune_cluster, stop={"step": 5}),
    )
    results = tuner.fit()
    best = results.get_best_result()
    assert best.metrics["step"] >= 5
    assert best.metrics["step"] < 99  # stopped early, not run out
    assert best.checkpoint is not None


def test_failure_retry_resumes_from_checkpoint(tune_cluster, tmp_path):
    marker = str(tmp_path / "crashed_once")

    def trainable(config):
        ckpt = tune.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt else 0
        for step in range(start, 6):
            tune.report({"step": step}, checkpoint=Checkpoint.from_dict({"step": step}))
            if step == 3 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("boom")

    tuner = tune.Tuner(
        trainable,
        param_space={"marker": marker},
        tune_config=tune.TuneConfig(metric="step", mode="max"),
        run_config=RunConfig(
            name="retry",
            storage_path=tune_cluster,
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    results = tuner.fit()
    best = results.get_best_result()
    assert best.error is None
    assert best.metrics["step"] == 5  # finished after the retry


def test_experiment_restore_restarts_errored(tune_cluster, tmp_path):
    """Driver-restart flow: first run leaves an ERROR trial; Tuner.restore
    re-runs it from the experiment checkpoint on disk."""
    marker = str(tmp_path / "fixed")

    def trainable(config):
        if config["kind"] == "bad" and not os.path.exists(config["marker"]):
            raise RuntimeError("deliberate failure")
        tune.report({"score": 1.0 if config["kind"] == "bad" else 0.5})

    exp_dir = os.path.join(tune_cluster, "restore_exp")
    tuner = tune.Tuner(
        trainable,
        param_space={"kind": tune.grid_search(["good", "bad"]), "marker": marker},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="restore_exp", storage_path=tune_cluster),
    )
    results = tuner.fit()
    assert len(results.errors) == 1

    # "fix the bug", then restore from disk — only the errored trial re-runs
    open(marker, "w").close()
    restored = tune.Tuner.restore(exp_dir, trainable, restart_errored=True)
    results2 = restored.fit()
    assert len(results2.errors) == 0
    assert len(results2) == 2
    assert results2.get_best_result().metrics["score"] == 1.0


def _pbt_trainable(config):
    """tests/test_tune.py's PBT and PB2 trainable."""
    import time

    ckpt = tune.get_checkpoint()
    state = ckpt.to_dict() if ckpt else {"value": 0.0, "step": 0}
    value, start = state["value"], state["step"] + 1
    for step in range(start, 31):
        value += config["lr"]  # higher lr -> faster growth
        tune.report(
            {"score": value, "training_iteration": step},
            checkpoint=Checkpoint.from_dict({"value": value, "step": step}),
        )
        # pace reports so driver polls interleave trials (PBT compares
        # populations at matching wall-clock progress)
        time.sleep(0.05)


def test_pbt_perturbs_and_improves(tune_cluster):
    scheduler = tune.PopulationBasedTraining(
        perturbation_interval=5,
        hyperparam_mutations={"lr": [0.1, 0.5, 1.0, 2.0]},
        quantile_fraction=0.5,
        seed=3,
    )
    tuner = tune.Tuner(
        _pbt_trainable,
        param_space={"lr": tune.grid_search([0.1, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max", scheduler=scheduler),
        run_config=RunConfig(name="pbt", storage_path=tune_cluster),
    )
    results = tuner.fit()
    assert scheduler.num_perturbations >= 1, "PBT never exploited"
    # The exploited trial inherits the fast trial's checkpoint, so both end high.
    scores = sorted(t.last_result["score"] for t in results.trials)
    assert scores[0] > 0.1 * 30  # the slow config alone would reach ~3.0


def _quadratic_loop(config):
    from ray_tpu_torch.train.session import report

    # toy quadratic: loss = (w - 1)^2 after config["lr"]-sized steps
    w = 0.0
    for step in range(5):
        w = w + config["lr"] * (1.0 - w)
        report({"loss": float((1.0 - w) ** 2), "training_iteration": step + 1})


def test_tuner_over_torch_trainer(tune_cluster):
    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    trainer = TorchTrainer(
        _quadratic_loop,
        torch_config=TorchConfig(device="cpu"),
        scaling_config=ScalingConfig(num_workers=1),
    )
    tuner = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search([0.01, 0.9])},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", resources_per_trial={"CPU": 2}
        ),
        run_config=RunConfig(name="trainer_tune", storage_path=tune_cluster),
    )
    results = tuner.fit()
    assert len(results) == 2
    best = results.get_best_result()
    assert best.metrics["config"]["lr"] == 0.9
    assert best.metrics["loss"] < 1e-3


def test_tpe_searcher_concentrates_near_optimum():
    """Model-based search (native TPE — the optuna/hyperopt algorithm):
    after the random warmup, suggestions must concentrate near the optimum
    of a smooth objective and beat pure random search's mean."""
    import random as _random

    from ray_tpu_torch.tune.search import TPESearcher

    def objective(cfg):
        return -((cfg["x"] - 0.7) ** 2) - 0.5 * (cfg["lr"] - 1e-2) ** 2

    space = {"x": tune.uniform(0.0, 1.0), "lr": tune.loguniform(1e-4, 1.0)}
    tpe = TPESearcher(space, num_samples=48, n_initial=8, seed=5)
    tpe.set_search_properties("score", "max")
    late = []
    for i in range(48):
        cfg = tpe.suggest(f"t{i}")
        score = objective(cfg)
        tpe.on_trial_complete(
            f"t{i}", {"score": score, "config": cfg}, error=False
        )
        if i >= 32:
            late.append(cfg["x"])
    assert tpe.suggest("t_done") is None  # budget exhausted
    # Late suggestions cluster near x*=0.7 much tighter than uniform draws.
    rng = _random.Random(5)
    uniform_dist = sum(abs(rng.uniform(0, 1) - 0.7) for _ in range(16)) / 16
    tpe_dist = sum(abs(x - 0.7) for x in late) / len(late)
    assert tpe_dist < uniform_dist * 0.6, (tpe_dist, uniform_dist)


def test_tpe_drives_tuner(tune_cluster):
    """TPE as the Tuner's search_alg end-to-end.  The runner must query
    the searcher INCREMENTALLY (refill after completions) — an upfront
    drain would leave every suggestion on the random-warmup path."""
    from ray_tpu_torch.tune.search import TPESearcher

    def trainable(config):
        tune.report({"score": -((config["x"] - 0.3) ** 2)})

    class SpyTPE(TPESearcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.obs_seen = []

        def suggest(self, trial_id):
            self.obs_seen.append(len(self._obs))
            return super().suggest(trial_id)

    space = {"x": tune.uniform(0.0, 1.0)}
    spy = SpyTPE(space, num_samples=20, n_initial=6, seed=2)
    tuner = tune.Tuner(
        trainable,
        param_space=space,
        tune_config=tune.TuneConfig(
            metric="score", mode="max", search_alg=spy,
        ),
        run_config=RunConfig(name="tpe", storage_path=tune_cluster),
    )
    results = tuner.fit()
    assert len(results) == 20
    # Later suggestions actually SAW completed observations (model path),
    # not just the warmup RNG.
    assert max(spy.obs_seen) >= spy.n_initial, spy.obs_seen
    best = results.get_best_result()
    assert abs(best.metrics["config"]["x"] - 0.3) < 0.15


@pytest.mark.slow  # pbt test is the fast population-based twin
def test_pb2_gp_explore_within_bounds(tune_cluster):
    """PB2: exploit inherits PBT's checkpoint copy; explore picks bounded
    hyperparams via the GP-UCB model, always inside the declared bounds."""
    scheduler = tune.PB2(
        perturbation_interval=5,
        hyperparam_bounds={"lr": (0.05, 2.0)},
        quantile_fraction=0.5,
        seed=4,
    )
    tuner = tune.Tuner(
        _pbt_trainable,
        param_space={"lr": tune.grid_search([0.05, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max", scheduler=scheduler),
        run_config=RunConfig(name="pb2", storage_path=tune_cluster),
    )
    results = tuner.fit()
    assert scheduler.num_perturbations >= 1, "PB2 never exploited"
    for t in results.trials:
        assert 0.05 <= t.config["lr"] <= 2.0
    scores = sorted(t.last_result["score"] for t in results.trials)
    assert scores[0] > 0.05 * 30  # the slow config alone reaches ~1.5


def test_pb2_gp_targets_known_optimum():
    """Regression for the GP-bandit explore itself: given observations of
    a deterministic improvement landscape peaking at lr*=0.5, PB2's UCB
    choices must concentrate near the optimum far tighter than uniform
    exploration — a silent regression to random picks fails this."""
    pb2 = tune.PB2(hyperparam_bounds={"lr": (0.0, 1.0)}, seed=7)
    for x in np.linspace(0.0, 1.0, 40):
        pb2._gp_data.append(([float(x)], float(-((x - 0.5) ** 2))))

    picks = []
    for _ in range(12):
        choice = pb2._gp_choose()
        assert choice is not None and 0.0 <= choice["lr"] <= 1.0
        picks.append(choice["lr"])
    gp_dist = float(np.mean([abs(p - 0.5) for p in picks]))
    rng = np.random.default_rng(7)
    uniform_dist = float(np.mean(np.abs(rng.uniform(0, 1, 200) - 0.5)))
    assert gp_dist < uniform_dist * 0.5, (gp_dist, uniform_dist)


# -- the JAX package's choices from the same seeds ----------------------------


def _space(t):
    """One search space in package `t`'s tune."""
    return {"a": t.grid_search([1, 2, 3]), "b": t.uniform(0, 1), "c": t.loguniform(1e-4, 1.0),
            "d": t.choice(["x", "y", "z"]), "e": t.randint(0, 10),
            "nested": {"f": t.grid_search([0.5, 1.5]), "g": t.uniform(-1, 1)}}


def _suggestions(searcher) -> list:
    out = []
    while (cfg := searcher.suggest(f"t{len(out)}")) is not None:
        out.append(cfg)
    return out


def test_basic_variant_generator_is_the_jax_package_s():
    from ray_tpu import tune as jax_tune

    for seed in (0, 7):
        got = _suggestions(tune.BasicVariantGenerator(_space(tune), num_samples=2, seed=seed))
        want = _suggestions(jax_tune.BasicVariantGenerator(_space(jax_tune), num_samples=2,
                                                           seed=seed))
        assert len(got) == 2 * 3 * 2
        assert got == want


def test_tpe_suggestions_are_the_jax_package_s():
    from ray_tpu import tune as jax_tune
    from ray_tpu.tune.search import TPESearcher as JaxTPE
    from ray_tpu_torch.tune.search import TPESearcher

    def objective(cfg):
        return -((cfg["x"] - 0.7) ** 2) - 0.5 * (np.log10(cfg["lr"]) + 2) ** 2 + (
            0.1 if cfg["opt"] == "adam" else 0.0)

    runs = []
    for t, cls in ((tune, TPESearcher), (jax_tune, JaxTPE)):
        space = {"x": t.uniform(0.0, 1.0), "lr": t.loguniform(1e-4, 1.0),
                 "opt": t.choice(["sgd", "adam"])}
        tpe = cls(space, num_samples=24, n_initial=6, seed=5)
        tpe.set_search_properties("score", "max")
        seen = []
        for i in range(24):
            cfg = tpe.suggest(f"t{i}")
            seen.append(cfg)
            tpe.on_trial_complete(f"t{i}", {"score": objective(cfg), "config": cfg}, error=False)
        assert tpe.suggest("done") is None
        runs.append(seen)
    assert runs[0] == runs[1]


def _scripted_reports(n_trials: int, steps: int):
    """A fixed stream of reports: trial i at step s reports a score that
    grows with s at trial i's rate, in round-robin order."""
    rates = np.random.default_rng(3).uniform(0.1, 2.0, n_trials)
    for step in range(1, steps + 1):
        for i in range(n_trials):
            yield i, {"score": float(rates[i] * step + 0.01 * i), "training_iteration": step}


def _decisions(t, scheduler, n_trials: int, steps: int) -> list:
    """The scheduler's decision on every report of the scripted stream, and
    each trial's config and checkpoint after it (package `t`'s Trial)."""
    trials = [t.Trial(config={"lr": [0.1, 0.5, 1.0, 2.0][i % 4]}, trial_id=f"t{i}")
              for i in range(n_trials)]
    scheduler.set_search_properties("score", "max")
    out = []
    for i, result in _scripted_reports(n_trials, steps):
        trial = trials[i]
        trial.checkpoint = f"ckpt-{trial.trial_id}-{result['training_iteration']}"
        out.append((trial.trial_id, scheduler.on_trial_result(trial, result),
                    dict(trial.config), trial.checkpoint))
    return out


@pytest.mark.parametrize("kind", ["asha", "pbt", "median"])
def test_scheduler_decisions_are_the_jax_package_s(kind):
    from ray_tpu import tune as jax_tune

    def make(t):
        if kind == "asha":
            return t.ASHAScheduler(grace_period=2, reduction_factor=2, max_t=12)
        if kind == "pbt":
            return t.PopulationBasedTraining(
                perturbation_interval=3, hyperparam_mutations={"lr": [0.1, 0.5, 1.0, 2.0]},
                quantile_fraction=0.5, seed=3)
        return t.MedianStoppingRule(grace_period=2, min_samples_required=2)

    got = _decisions(tune, make(tune), 6, 14)
    want = _decisions(jax_tune, make(jax_tune), 6, 14)
    decisions = {d for _, d, _, _ in got}
    assert "STOP" in decisions or "RESTART" in decisions  # the stream exercises them
    assert got == want


def test_pb2_choices_are_the_jax_package_s():
    from ray_tpu import tune as jax_tune

    picks = []
    for t in (tune, jax_tune):
        pb2 = t.PB2(hyperparam_bounds={"lr": (0.0, 1.0), "wd": (1e-4, 1e-1)}, seed=7)
        for x in np.linspace(0.0, 1.0, 20):
            pb2._gp_data.append(([float(x), float(x) * 0.1], float(-((x - 0.4) ** 2))))
        picks.append([pb2._gp_choose() for _ in range(6)])
    assert picks[0] == picks[1]


# -- card ids through tune ----------------------------------------------------


def test_concurrent_gpu_trials_hold_distinct_card_ids(tune_cluster, tmp_path):
    """Two trials that each ask for {"CPU": 1, "GPU": 1} run at once (each
    waits, bounded, until both have started) and hold distinct card ids,
    which their CUDA_VISIBLE_DEVICES names, as num_gpus=1 actors do."""
    rendezvous = str(tmp_path)

    def trainable(config):
        import ray_tpu_torch

        open(os.path.join(config["dir"], config["name"]), "w").close()
        deadline = time.monotonic() + 60
        while len(os.listdir(config["dir"])) < 2:
            if time.monotonic() > deadline:
                raise RuntimeError("the other trial never started")
            time.sleep(0.05)
        tune.report({"gpu_ids": ray_tpu_torch.get_gpu_ids(),
                     "visible": os.environ.get("CUDA_VISIBLE_DEVICES")})

    results = tune.Tuner(
        trainable,
        param_space={"name": tune.grid_search(["a", "b"]), "dir": rendezvous},
        tune_config=tune.TuneConfig(resources_per_trial={"CPU": 1, "GPU": 1}),
        run_config=RunConfig(name="cards", storage_path=tune_cluster),
    ).fit()
    assert len(results.errors) == 0
    ids = sorted(t.last_result["gpu_ids"] for t in results.trials)
    assert ids == [[0], [1]]
    for t in results.trials:
        assert t.last_result["visible"] == ",".join(map(str, t.last_result["gpu_ids"]))


def _card_holder_loop(config):
    """Holds both "GPU"s of the runtime: marks the holder file for its
    run, which no other worker may hold at once."""
    from ray_tpu_torch.train.session import report

    holder = os.path.join(config["dir"], "holder")
    with open(holder, "x") as f:  # raises if another worker holds the cards
        f.write(config["name"])
    try:
        time.sleep(0.5)
        report({"gpu_ids": ray_tpu_torch.get_gpu_ids(), "name": config["name"]})
    finally:
        os.unlink(holder)


def test_trainer_trials_whose_workers_need_every_card_take_them_in_turn(tune_cluster, tmp_path):
    """A Tuner over a TorchTrainer whose worker reserves both "GPU"s: the
    two trials start together, the second's worker waits for the cards
    until the first trial's trainer ends, and both end TERMINATED."""
    from ray_tpu_torch.air.config import ScalingConfig
    from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

    trainer = TorchTrainer(
        _card_holder_loop,
        train_loop_config={"dir": str(tmp_path)},
        torch_config=TorchConfig(device="cpu"),
        scaling_config=ScalingConfig(num_workers=1, resources_per_worker={"CPU": 1, "GPU": 2}),
    )
    results = tune.Tuner(
        trainer,
        param_space={"name": tune.grid_search(["first", "second"])},
        tune_config=tune.TuneConfig(resources_per_trial={"CPU": 1}),
        run_config=RunConfig(name="in_turn", storage_path=tune_cluster),
    ).fit()
    assert len(results.errors) == 0
    assert [t.status for t in results.trials] == ["TERMINATED", "TERMINATED"]
    assert sorted(t.last_result["name"] for t in results.trials) == ["first", "second"]
    assert [t.last_result["gpu_ids"] for t in results.trials] == [[0, 1], [0, 1]]
