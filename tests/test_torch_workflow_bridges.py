"""The port's durable workflows (`ray_tpu_torch.workflow`) and its bridges
over the task runtime (`util.multiprocessing.Pool`, the joblib backend,
`Dataset.iter_torch_batches`), on the CPU only (none touches a card).

tests/test_dag_workflow_env.py's workflow cases and tests/test_util_bridges.py's
cases, on the port's copies; the joblib backend registers under the name
the copy gives it, "ray_tpu_torch". One port runtime serves the file. This
module imports jax and ray_tpu nowhere.
"""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch import workflow


@pytest.fixture(scope="module", autouse=True)
def rt():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


# -- workflow ----------------------------------------------------------------


def test_workflow_run_and_durable_output(tmp_path):
    workflow.init(str(tmp_path))

    @ray_tpu_torch.remote
    def fetch():
        return [1, 2, 3]

    @ray_tpu_torch.remote
    def total(xs):
        return sum(xs)

    out = workflow.run(total.bind(fetch.bind()), workflow_id="wf-basic")
    assert out == 6
    assert workflow.get_status("wf-basic") == workflow.SUCCEEDED
    assert workflow.get_output("wf-basic") == 6
    assert {"workflow_id": "wf-basic", "status": "SUCCEEDED"} in workflow.list_all()


def test_workflow_resume_skips_completed_steps(tmp_path):
    workflow.init(str(tmp_path))
    marker = tmp_path / "exec-count"

    @ray_tpu_torch.remote
    def step_a():
        with open(marker, "a") as f:
            f.write("a")
        return 5

    @ray_tpu_torch.remote
    def step_b(x):
        with open(marker, "a") as f:
            f.write("b")
        return x * 2

    out = workflow.run(step_b.bind(step_a.bind()), workflow_id="wf-resume")
    assert out == 10
    assert marker.read_text() == "ab"

    # Simulate a crash after step_a: delete step_b's durable result only.
    wf_dir = tmp_path / "wf-resume"
    removed = [p for p in os.listdir(wf_dir) if p.startswith("step_b")]
    assert removed
    for p in removed:
        os.unlink(wf_dir / p)
    (wf_dir / "status").write_text(workflow.RUNNING)

    out2 = workflow.resume("wf-resume")
    assert out2 == 10
    # step_a was NOT re-executed (durable), step_b was.
    assert marker.read_text() == "abb"


# -- bridges -----------------------------------------------------------------


def test_multiprocessing_pool_shim():
    """Drop-in Pool over the task runtime (ray: util/multiprocessing):
    map/starmap/apply/imap semantics match the stdlib contract."""
    from ray_tpu_torch.util.multiprocessing import Pool

    def sq(x):
        return x * x

    with Pool(processes=4) as pool:
        assert pool.map(sq, range(10)) == [x * x for x in range(10)]
        assert pool.apply(sq, (7,)) == 49
        ar = pool.apply_async(sq, (8,))
        assert ar.get(timeout=30) == 64 and ar.ready() and ar.successful()
        assert pool.starmap(lambda a, b: a + b, [(1, 2), (3, 4)]) == [3, 7]
        assert list(pool.imap(sq, range(6), chunksize=2)) == [0, 1, 4, 9, 16, 25]
        assert sorted(pool.imap_unordered(sq, range(6), chunksize=2)) == [
            0, 1, 4, 9, 16, 25,
        ]
    with pytest.raises(ValueError):
        pool.map(sq, [1])  # closed


def test_dataset_iter_torch_batches():
    from ray_tpu_torch import data as rdata

    ds = rdata.from_items([{"x": float(i), "y": i} for i in range(20)])
    batches = list(ds.iter_torch_batches(batch_size=8))
    import torch

    assert all(isinstance(b["x"], torch.Tensor) for b in batches)
    assert [len(b["y"]) for b in batches] == [8, 8, 4]
    assert float(batches[0]["x"][3]) == 3.0
    # Per-column dtypes dict (the Ray API form).
    b = next(iter(ds.iter_torch_batches(
        batch_size=4, dtypes={"x": torch.float32, "y": torch.int64})))
    assert b["x"].dtype == torch.float32 and b["y"].dtype == torch.int64


@pytest.mark.slow  # other bridge tests in this file are the fast twins
def test_joblib_backend():
    """scikit-learn's joblib parallelism over the cluster (ray:
    util/joblib register_ray): cross-validation folds run as tasks."""
    import joblib

    from ray_tpu_torch.util.joblib import register_ray

    register_ray()
    with joblib.parallel_backend("ray_tpu_torch"):
        outs = joblib.Parallel(n_jobs=4)(
            joblib.delayed(lambda x: x * x)(i) for i in range(12)
        )
    assert outs == [i * i for i in range(12)]

    # A real sklearn workload end-to-end.
    from sklearn.datasets import make_classification
    from sklearn.linear_model import LogisticRegression
    from sklearn.model_selection import cross_val_score

    X, y = make_classification(n_samples=200, n_features=8, random_state=0)
    with joblib.parallel_backend("ray_tpu_torch"):
        scores = cross_val_score(LogisticRegression(max_iter=200), X, y, cv=4)
    assert len(scores) == 4 and all(0.5 < s <= 1.0 for s in scores)
