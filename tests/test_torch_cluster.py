"""The port's cluster layer: the autoscaler, job submission, the cluster
fixture and the CLI (copies of `ray_tpu`'s, package name rewritten).

The cases of tests/test_autoscaler_jobs.py and the CLI cases of
tests/test_moe_dashboard_cli.py run here on the port, the TPU-discovery
case as its "GPU" twin; then what the port adds to them: a head started by
the CLI serving an attached driver, a "GPU" demand on a head without one
scaling up a node whose worker gets its card id, a daemon node's worker
receiving its card ids, and a job running the tiny decoder's forward against
the JAX package's. Card ids are declared "GPU"s here: this box has no card.
This file imports jax and ray_tpu only inside functions (a task defined
here is pickled by reference, so its worker imports this module).
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (
    AutoscalerConfig,
    LocalNodeProvider,
    NodeProvider,
    NodeTypeConfig,
    StandardAutoscaler,
)
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.job_submission import FAILED, STOPPED, SUCCEEDED, JobSubmissionClient

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO)}


def wait_for_resource_release(resource, target, timeout_s=10.0):
    """tests/conftest.py's helper on the port's runtime."""
    deadline = time.monotonic() + timeout_s
    avail = None
    while time.monotonic() < deadline:
        avail = ray_tpu_torch.available_resources().get(resource)
        if avail == target:
            break
        time.sleep(0.2)
    return avail


@pytest.fixture
def rt():
    ray_tpu_torch.init(num_cpus=1, ignore_reinit_error=True)
    yield
    ray_tpu_torch.shutdown()


def _autoscaler(idle_timeout=60.0, max_workers=5, min_workers=0, resources=None):
    provider = LocalNodeProvider()
    config = AutoscalerConfig(
        node_types={
            "cpu-2": NodeTypeConfig(
                resources=resources or {"CPU": 2.0},
                min_workers=min_workers,
                max_workers=max_workers,
            ),
        },
        idle_timeout_s=idle_timeout,
    )
    return StandardAutoscaler(provider, config), provider


# -- tests/test_autoscaler_jobs.py on the port ---------------------------------


def test_scale_up_for_queued_tasks(rt):
    autoscaler, provider = _autoscaler()

    @ray_tpu_torch.remote(num_cpus=2)
    def heavy():
        return os.getpid()

    refs = [heavy.remote() for _ in range(3)]  # head has 1 CPU: all queued
    time.sleep(0.3)
    result = autoscaler.update()
    assert sum(result["launched"].values()) >= 1
    out = ray_tpu_torch.get(refs, timeout=120)
    assert len(out) == 3
    assert len(provider.non_terminated_nodes()) >= 1


def test_min_workers_floor_and_max_cap(rt):
    autoscaler, provider = _autoscaler(min_workers=2, max_workers=3)
    result = autoscaler.update()
    assert sum(result["launched"].values()) == 2  # floors

    @ray_tpu_torch.remote(num_cpus=2)
    def f():
        time.sleep(10)

    _ = [f.remote() for _ in range(10)]
    time.sleep(0.3)
    autoscaler.update()
    autoscaler.update()
    assert len(provider.non_terminated_nodes()) <= 3  # max_workers cap


def test_idle_nodes_terminated(rt):
    autoscaler, provider = _autoscaler(idle_timeout=0.2)

    @ray_tpu_torch.remote(num_cpus=2)
    def quick():
        return 1

    refs = [quick.remote() for _ in range(2)]
    time.sleep(0.3)
    autoscaler.update()
    assert ray_tpu_torch.get(refs, timeout=120) == [1, 1]
    deadline = time.time() + 30
    while time.time() < deadline:
        time.sleep(0.3)
        autoscaler.update()
        if not provider.non_terminated_nodes():
            break
    assert not provider.non_terminated_nodes()


def test_infeasible_demand_not_launched(rt):
    autoscaler, provider = _autoscaler()

    @ray_tpu_torch.remote(num_cpus=64)
    def impossible():
        return 1

    _ = impossible.remote()  # parks (autoscaler attached), never awaited
    time.sleep(0.2)
    with pytest.warns(UserWarning, match="NO configured node type"):
        result = autoscaler.update()
    assert sum(result["launched"].values()) == 0
    assert result["infeasible"] == [{"CPU": 64.0}]
    result2 = autoscaler.update()
    assert sum(result2["launched"].values()) == 0


def test_gpu_resource_discovery_env():
    """The twin of test_tpu_resource_discovery_env: RAY_TPU_CHIPS declares
    the head's cards, here as the "GPU" resource."""
    os.environ["RAY_TPU_CHIPS"] = "4"
    try:
        ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
        assert ray_tpu_torch.cluster_resources().get("GPU") == 4.0
        assert "TPU" not in ray_tpu_torch.cluster_resources()

        @ray_tpu_torch.remote(num_gpus=1)
        def on_card():
            return "ok"

        assert ray_tpu_torch.get(on_card.remote(), timeout=60) == "ok"
        assert wait_for_resource_release("GPU", 4.0) == 4.0
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_CHIPS", None)


def test_job_lifecycle(tmp_path):
    client = JobSubmissionClient(log_dir=str(tmp_path))
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('hello-from-job')\"",
        metadata={"owner": "test"},
    )
    status = client.wait_until_finish(job_id, timeout=60)
    assert status == SUCCEEDED
    assert "hello-from-job" in client.get_job_logs(job_id)
    info = client.get_job_info(job_id)
    assert info.return_code == 0 and info.metadata["owner"] == "test"
    assert client.list_jobs()[0].job_id == job_id


def test_job_failure_and_env_vars(tmp_path):
    client = JobSubmissionClient(log_dir=str(tmp_path))
    ok = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import os; print(os.environ['MY_FLAG'])\"",
        runtime_env={"env_vars": {"MY_FLAG": "flag-value-42"}},
    )
    bad = client.submit_job(entrypoint=f"{sys.executable} -c \"raise SystemExit(3)\"")
    assert client.wait_until_finish(ok, timeout=60) == SUCCEEDED
    assert "flag-value-42" in client.get_job_logs(ok)
    assert client.wait_until_finish(bad, timeout=60) == FAILED
    assert client.get_job_info(bad).return_code == 3


def test_job_stop(tmp_path):
    client = JobSubmissionClient(log_dir=str(tmp_path))
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import time; time.sleep(600)\""
    )
    time.sleep(0.5)
    assert client.stop_job(job_id)
    assert client.wait_until_finish(job_id, timeout=30) == STOPPED
    assert not client.stop_job(job_id)  # already terminal


def test_inflight_boots_not_relaunched(rt):
    class SlowBootProvider(NodeProvider):
        def __init__(self):
            super().__init__()
            self.created = []

        def non_terminated_nodes(self):
            return list(self.created)

        def node_resources(self, pid):
            return {"CPU": 2.0}

        def node_type(self, pid):
            return "cpu-2"

        def create_node(self, node_type, resources):
            pid = f"slow-{len(self.created)}"
            self.created.append(pid)
            return pid

        def terminate_node(self, pid):
            self.created.remove(pid)

        def runtime_node_id(self, pid):
            return None  # still booting forever (the test never joins them)

    provider = SlowBootProvider()
    config = AutoscalerConfig(
        node_types={"cpu-2": NodeTypeConfig(resources={"CPU": 2.0}, max_workers=10)},
    )
    autoscaler = StandardAutoscaler(provider, config)

    @ray_tpu_torch.remote(num_cpus=2)
    def f():
        return 1

    _ = f.remote()
    time.sleep(0.2)
    r1 = autoscaler.update()
    assert sum(r1["launched"].values()) == 1
    for _ in range(3):
        rn = autoscaler.update()
        assert sum(rn["launched"].values()) == 0, "relaunched for in-flight boot"
    assert len(provider.created) == 1


def test_tpu_pod_provider_with_fake_gcloud(tmp_path):
    """TPUPodNodeProvider (kept verbatim) behind a fake `gcloud` that boots
    the "VM" by running its startup script here: the port's node daemon
    registers the pre-assigned id with its "TPU" resource, a task that asks
    for it runs there, and terminate deletes the VM."""
    from ray_tpu_torch._private import config as _config
    from ray_tpu_torch._private.runtime import get_runtime
    from ray_tpu_torch.autoscaler.node_provider import TPUPodNodeProvider

    log = tmp_path / "gcloud.log"
    pids = tmp_path / "pids"
    pids.mkdir()
    fake = tmp_path / "gcloud"
    fake.write_text(textwrap.dedent(f"""\
        #!/usr/bin/env python3
        import json, os, subprocess, sys, signal
        args = sys.argv[1:]
        with open({str(log)!r}, "a") as f:
            f.write(json.dumps(args) + "\\n")
        if "create" in args:
            name = args[args.index("create") + 1]
            meta = next(a for a in args if a.startswith("--metadata=startup-script="))
            script = meta.split("=", 2)[2]
            env = dict(os.environ)
            env["PYTHONPATH"] = {str(REPO)!r} + os.pathsep + env.get("PYTHONPATH", "")
            p = subprocess.Popen(["bash", "-c", script], env=env,
                                 start_new_session=True,
                                 stdout=open({str(tmp_path / "vm.out")!r}, "ab"),
                                 stderr=open({str(tmp_path / "vm.err")!r}, "ab"))
            with open(os.path.join({str(pids)!r}, name), "w") as f:
                f.write(str(p.pid))
        elif "delete" in args:
            name = args[args.index("delete") + 1]
            try:
                with open(os.path.join({str(pids)!r}, name)) as f:
                    os.killpg(int(f.read()), signal.SIGTERM)
            except (OSError, ValueError):
                pass
        print("[]")
    """))
    fake.chmod(0o755)

    old_path = os.environ["PATH"]
    os.environ["PATH"] = f"{tmp_path}{os.pathsep}{old_path}"
    try:
        ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True,
                           _system_config={"bind_host": "0.0.0.0"})
        provider = TPUPodNodeProvider(
            {"project": "proj", "zone": "us-z", "head_host": "127.0.0.1"}
        )
        pid = provider.create_node("v5p-8", {"CPU": 2.0, "TPU": 4.0})
        assert pid in provider.non_terminated_nodes()
        assert provider.node_type(pid) == "v5p-8"
        rt = get_runtime()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            nid = provider.runtime_node_id(pid)
            if nid is not None:
                break
            time.sleep(0.2)
        assert nid is not None, "fake TPU VM daemon never joined"
        assert rt.state.nodes[nid].resources.get("TPU") == 4.0

        @ray_tpu_torch.remote(resources={"TPU": 1.0})
        def on_tpu():
            return "ok"

        assert ray_tpu_torch.get(on_tpu.remote(), timeout=60) == "ok"

        provider.terminate_node(pid)
        assert pid not in provider.non_terminated_nodes()
        calls = [json.loads(line) for line in log.read_text().splitlines()]
        assert any("create" in c for c in calls)
        assert any("delete" in c for c in calls)
        assert all("--project=proj" in c for c in calls)
        vm_cmd = next(c for c in calls if "create" in c)
        assert any("python -m ray_tpu_torch._private.node_daemon" in a for a in vm_cmd)
    finally:
        ray_tpu_torch.shutdown()
        os.environ["PATH"] = old_path
        os.environ.pop("RAY_TPU_BIND_HOST", None)
        _config._reset_for_tests()
        for pf in pids.iterdir():
            try:
                os.killpg(int(pf.read_text()), signal.SIGTERM)
            except (OSError, ValueError):
                pass


def test_job_pip_runtime_env_and_validation(tmp_path):
    ray_tpu_torch.init(num_cpus=2, ignore_reinit_error=True)
    try:
        client = JobSubmissionClient(log_dir=str(tmp_path / "logs"))
        with pytest.raises(Exception, match="unsupported runtime_env"):
            client.submit_job(
                entrypoint="python -c 'pass'",
                runtime_env={"conda": {}},
                submission_id="envjob",
            )
        assert "envjob" not in [j.job_id for j in client.list_jobs()]

        pkg = tmp_path / "jobpkg"
        pkg.mkdir()
        (pkg / "pyproject.toml").write_text(
            '[build-system]\nrequires=["setuptools"]\n'
            'build-backend="setuptools.build_meta"\n'
            '[project]\nname="jobmod"\nversion="0.1"\n'
            "[tool.setuptools]\npy-modules=[\"jobmod_xyz\"]\n"
        )
        (pkg / "jobmod_xyz.py").write_text("ANSWER = 7\n")
        jid = client.submit_job(
            entrypoint="python -c 'import jobmod_xyz; print(jobmod_xyz.ANSWER * 6)'",
            runtime_env={"pip": [str(pkg)]},
            submission_id="envjob",  # the rejected id is free again
        )
        assert client.wait_until_finish(jid, timeout=120) == SUCCEEDED, \
            client.get_job_logs(jid)[-400:]
        assert "42" in client.get_job_logs(jid)
    finally:
        ray_tpu_torch.shutdown()


# -- the CLI (tests/test_moe_dashboard_cli.py's cases on the port) ---------------


def _cli(*args, env=None, timeout=120):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
                          capture_output=True, text=True, timeout=timeout, env=env or ENV)


def test_cli_status_and_timeline(tmp_path):
    out = _cli("status")
    assert out.returncode == 0, out.stderr[-500:]
    data = json.loads(out.stdout)
    assert "nodes" in data and "resources" in data

    tl_path = tmp_path / "tl.json"
    out2 = _cli("timeline", "-o", str(tl_path))
    assert out2.returncode == 0, out2.stderr[-500:]
    assert json.loads(tl_path.read_text()) == []  # fresh runtime: no tasks


def _gone(pid: int) -> bool:
    """The process no longer runs (gone, or a zombie nobody reaped yet)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def _wait_gone(pids, timeout_s=30.0) -> list:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not all(_gone(p) for p in pids):
        time.sleep(0.2)
    return [p for p in pids if not _gone(p)]


ATTACHED_DRIVER = """
import json, os, sys
import ray_tpu_torch

ray_tpu_torch.init(address=sys.argv[1])

@ray_tpu_torch.remote(num_gpus=1)
def probe():
    return ray_tpu_torch.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES"), os.getpid()

print(json.dumps(ray_tpu_torch.get(probe.remote(), timeout=60)))
ray_tpu_torch.shutdown()
"""


def test_cli_head_serves_an_attached_driver_and_stops(tmp_path):
    """`start --head` under tmp_path with one declared card, a driver that
    attaches through head.json and runs a num_gpus=1 task there (card id 0),
    `status --address` showing the "GPU", and `stop` ending the head and
    its worker."""
    session = tmp_path / "session"
    env = {**ENV, "RAY_TPU_CHIPS": "1"}
    env.pop("CUDA_VISIBLE_DEVICES", None)
    out = _cli("start", "--head", "--num-cpus", "2", "--session-dir", str(session), env=env)
    assert out.returncode == 0, out.stderr[-800:]
    head_json = session / "head.json"
    head_pid = int((session / "head.pid").read_text())
    try:
        assert str(head_json) in out.stdout
        again = _cli("start", "--head", "--session-dir", str(session), env=env)
        assert again.returncode == 1 and "already running" in again.stderr

        driver = subprocess.run([sys.executable, "-c", ATTACHED_DRIVER, str(head_json)],
                                capture_output=True, text=True, timeout=120, env=ENV)
        assert driver.returncode == 0, driver.stderr[-800:]
        ids, visible, worker_pid = json.loads(driver.stdout.strip().splitlines()[-1])
        assert ids == [0] and visible == "0"

        status = _cli("status", "--address", str(head_json))
        assert status.returncode == 0, status.stderr[-800:]
        assert json.loads(status.stdout)["resources"].get("GPU") == 1.0

        stop = _cli("stop", "--session-dir", str(session))
        assert stop.returncode == 0 and f"pid {head_pid}" in stop.stdout
        assert _wait_gone([head_pid, worker_pid]) == []
        assert not (session / "head.pid").exists()
    finally:
        if not _gone(head_pid):
            os.kill(head_pid, signal.SIGKILL)


# -- card ids on the nodes the cluster layer adds -----------------------------------


@ray_tpu_torch.remote(num_gpus=1)
def card_probe():
    """A worker's card ids, its CUDA_VISIBLE_DEVICES and, on a daemon node,
    its node's id."""
    return (ray_tpu_torch.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES"),
            os.environ.get("RAY_TPU_NODE_ID"))


def test_gpu_demand_scales_up_a_node_whose_worker_gets_its_card(monkeypatch):
    """A num_gpus=1 task on a head without a "GPU" waits; the autoscaler
    launches the one {"CPU": 2, "GPU": 1} node it fits; the task runs there
    with card id 0; idle, the node is terminated."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv("RAY_TPU_CHIPS", raising=False)
    ray_tpu_torch.init(num_cpus=1)
    try:
        assert "GPU" not in ray_tpu_torch.cluster_resources()
        autoscaler, provider = _autoscaler(idle_timeout=0.5, max_workers=1,
                                           resources={"CPU": 2.0, "GPU": 1.0})
        ref = card_probe.remote()
        time.sleep(0.3)
        assert autoscaler.update()["launched"] == {"cpu-2": 1}
        (pid,) = provider.non_terminated_nodes()
        ids, visible, _ = ray_tpu_torch.get(ref, timeout=120)  # the head has no "GPU"
        assert (ids, visible) == ([0], "0")
        assert autoscaler.update()["launched"] == {}
        deadline = time.time() + 30
        while provider.non_terminated_nodes() and time.time() < deadline:
            time.sleep(0.3)
            autoscaler.update()
        assert provider.non_terminated_nodes() == []
        assert "GPU" not in ray_tpu_torch.cluster_resources()
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("how", ["cluster_add_node", "provider_use_daemons"])
def test_daemon_node_worker_receives_its_card_ids(how, monkeypatch):
    """A node-daemon process's worker starts with the grant's card in
    CUDA_VISIBLE_DEVICES and RAY_TPU_GPU_IDS: ids ride in the runtime env,
    which the daemon's worker pool applies as the head's does."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv("RAY_TPU_CHIPS", raising=False)
    cluster = Cluster(head_node_args={"num_cpus": 1})
    try:
        if how == "cluster_add_node":
            nid = cluster.add_node(num_cpus=1, resources={"GPU": 1}, daemon=True)
        else:
            provider = LocalNodeProvider({"use_daemons": True})
            nid = provider.runtime_node_id(provider.create_node("gpu", {"CPU": 1, "GPU": 1}))
        from ray_tpu_torch._private.runtime import get_runtime

        assert nid in get_runtime()._daemon_procs
        ids, visible, node = ray_tpu_torch.get(card_probe.remote(), timeout=120)
        assert (ids, visible, node) == ([0], "0", nid)
    finally:
        cluster.shutdown()


# -- a job running the decoder ---------------------------------------------------


DECODER_JOB = """
import pickle, sys
import numpy as np, torch
from ray_tpu_torch.models import TransformerConfig, forward, params_from_numpy

d = sys.argv[1]
with open(f"{d}/params.pkl", "rb") as f:
    tree = pickle.load(f)
cfg = TransformerConfig.tiny()
params = params_from_numpy(tree, device="cpu")
with torch.no_grad():
    logits = forward(params, torch.as_tensor(np.load(f"{d}/tokens.npy")), cfg)
np.save(f"{d}/logits.npy", logits.numpy())
print("decoder job: logits", tuple(logits.shape), sorted(
    m for m in sys.modules if m.split(".")[0] in ("ray_tpu", "jax", "jaxlib")))
"""


def test_job_runs_the_decoder_forward_as_jax_does(tmp_path):
    """A submitted job (its own process, the port imported from the repo
    through working_dir) runs the tiny decoder's forward on the CPU from a
    JAX tree handed over as numpy: its logits are the JAX forward's at
    1e-5, and it loads nothing of the JAX package."""
    import jax

    from ray_tpu.models import transformer as jax_tf

    cfg = jax_tf.TransformerConfig.tiny()
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)
    np.save(tmp_path / "tokens.npy", tokens)
    (tmp_path / "job.py").write_text(DECODER_JOB)
    ref = np.asarray(jax_tf.forward(params, tokens, cfg))

    client = JobSubmissionClient(log_dir=str(tmp_path / "logs"))
    job = client.submit_job(entrypoint=f"{sys.executable} {tmp_path / 'job.py'} {tmp_path}",
                            runtime_env={"working_dir": str(REPO)})
    assert client.wait_until_finish(job, timeout=120) == SUCCEEDED, client.get_job_logs(job)
    assert f"decoder job: logits {ref.shape} []" in client.get_job_logs(job)
    np.testing.assert_allclose(np.load(tmp_path / "logits.npy"), ref, rtol=0, atol=1e-5)
