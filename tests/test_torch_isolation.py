"""Guards for the PyTorch port: it stands alone (no jax, optax or orbax,
nothing of ray_tpu), it does not quietly run on the CPU, and its kernel wrapper raises
on what the kernel does not take instead of falling back."""

import ast
import re
from pathlib import Path

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.models import LMTrainContext, TransformerConfig, init_params
from ray_tpu_torch.ops.cuda import _build
from ray_tpu_torch.ops.cuda import flash_attention as flash
from ray_tpu_torch.parallel import MeshSpec, build_mesh, setup_mesh

REPO = Path(__file__).resolve().parents[1]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ray_tpu", "optax", "orbax")


def test_port_imports_neither_jax_nor_ray_tpu():
    files = sorted(Path(ray_tpu_torch.__file__).parent.rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    files += [REPO / "scripts" / f"{name}.py" for name in (
        "ray_tpu_torch_lint", "profile_step_gpu", "wire_fuzz_torch", "chaos_soak_torch",
        "serve_bench_torch", "scale_bench_torch")]
    assert len(files) > 10
    scanned = {str(f.relative_to(REPO)) for f in files}
    assert {"ray_tpu_torch/models/lm.py", "ray_tpu_torch/models/convert.py",
            "ray_tpu_torch/ops/cuda/flash_attention.py", "ray_tpu_torch/ops/ring_attention.py",
            "ray_tpu_torch/parallel/__init__.py", "ray_tpu_torch/parallel/mesh.py",
            "ray_tpu_torch/parallel/sharding.py", "ray_tpu_torch/parallel/bootstrap.py",
            "ray_tpu_torch/parallel/collectives.py", "ray_tpu_torch/parallel/pipeline.py",
            "ray_tpu_torch/models/moe.py", "ray_tpu_torch/dryrun.py",
            "ray_tpu_torch/air/__init__.py", "ray_tpu_torch/air/checkpoint.py"} <= scanned
    rllib = {"__init__", "sample_batch", "env", "policy", "rl_module", "env_runner", "ppo",
             "impala", "appo", "dqn", "sac", "multi_agent", "algorithm", "offline",
             "policy_client"}
    assert {f"ray_tpu_torch/rllib/{m}.py" for m in rllib} <= scanned
    runtime = {"__init__", "actor", "remote_function", "exceptions", "dag", "dashboard",
               "_private/runtime", "_private/worker_proc", "_private/zygote",
               "_private/node_daemon", "_private/head", "_private/io_shard", "_private/gpu_ids",
               "_private/serialization", "_native/arena", "util/placement_group",
               "data/dataset", "train/__init__", "train/backend", "train/worker_group",
               "train/backend_executor", "train/data_parallel_trainer", "train/session",
               "air/config", "air/result", "air/preprocessors", "air/batch_predictor",
               "serve/__init__", "serve/api", "serve/config", "serve/controller",
               "serve/router", "serve/replica", "serve/http_proxy", "serve/batching"}
    assert {f"ray_tpu_torch/{m}.py" for m in runtime} <= scanned
    libraries = {"tune/__init__", "tune/trial", "tune/search", "tune/schedulers",
                 "tune/trial_runner", "tune/tuner", "workflow/__init__", "train/torch/__init__",
                 "train/torch/config", "train/torch/torch_trainer",
                 "train/torch/train_loop_utils", "util/multiprocessing", "util/joblib"}
    assert {f"ray_tpu_torch/{m}.py" for m in libraries} <= scanned
    cluster = {"job_submission", "cluster_utils", "autoscaler/__init__", "autoscaler/autoscaler",
               "autoscaler/node_provider", "_private/ray_perf", "scripts/__init__", "scripts/cli"}
    assert {f"ray_tpu_torch/{m}.py" for m in cluster} <= scanned
    analysis = {"__init__", "allowlist", "blocking", "common", "copy_coverage", "fault_registry",
                "gcs_mutation", "hot_send", "journal_coverage", "knob_registry", "lock_order",
                "metric_names", "span_names", "wire_schema"}
    assert {f"ray_tpu_torch/_private/analysis/{m}.py" for m in analysis} <= scanned
    bad = [
        (str(f.relative_to(REPO)), m) for f in files for m in _imported_modules(f) if _forbidden(m)
    ]
    assert bad == []


def _strings(path: Path):
    """The string constants of a file that are not docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            yield node.lineno, node.value


def test_port_names_no_module_of_ray_tpu_in_a_string():
    """No string of the port that could reach `python -m`, importlib or a
    pickle names a module of the JAX package (the runtime copy starts its
    processes by module name)."""
    files = sorted(Path(ray_tpu_torch.__file__).parent.rglob("*.py"))
    bad = [(str(f.relative_to(REPO)), line, text) for f in files for line, text in _strings(f)
           if re.search(r"\bray_tpu(\.\w|$)", text)]
    assert bad == []
    launched = [text for f in files for _, text in _strings(f)
                if re.fullmatch(r"ray_tpu_torch\._private\.\w+", text)]
    assert {"ray_tpu_torch._private.worker_proc", "ray_tpu_torch._private.zygote",
            "ray_tpu_torch._private.node_daemon", "ray_tpu_torch._private.head"} <= set(launched)


def test_entry_point_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(TransformerConfig.tiny(), torch.Generator())


def test_build_mesh_without_device_type_raises_when_no_card(monkeypatch):
    """A mesh is of CUDA cards unless the caller asks for CPU processes; the
    check comes before any process group is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        build_mesh()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        setup_mesh(MeshSpec(data=1))
    assert not torch.distributed.is_initialized()


def test_train_context_without_device_raises_when_no_card(monkeypatch):
    """Training runs on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMTrainContext(TransformerConfig.tiny())


@pytest.mark.parametrize(
    "dtype,d,bad",
    [(torch.float16, 128, "type"), (torch.bfloat16, 96, "head_dim"),
     (torch.bfloat16, 128, "stride")],
)
def test_kernel_input_check_raises(dtype, d, bad):
    """What a CUDA-typed request the kernel cannot serve meets before any
    launch; the check reads only shapes, types and strides (meta tensors)."""
    q = torch.empty((1, 64, 2, d), dtype=dtype, device="meta")
    if bad == "stride":
        q = torch.empty((1, 64, 2, 2 * d), dtype=dtype, device="meta")[..., ::2]
    with pytest.raises((TypeError, ValueError)):
        flash._check_kernel_inputs(q, q, q)


def test_wrapper_raises_on_devices_it_has_no_kernel_for():
    q = torch.empty((1, 64, 2, 128), dtype=torch.bfloat16, device="meta")
    before = _build.launch_counts()
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash.flash_attention(q, q, q)
    assert _build.launch_counts() == before


def test_cpu_tensors_take_the_plain_version_without_counting():
    q = torch.zeros((1, 16, 2, 64), requires_grad=True)
    before = _build.launch_counts()
    flash.flash_attention(q, q, q).sum().backward()
    assert q.grad is not None
    assert _build.launch_counts() == before


def test_backward_wrapper_raises_on_devices_it_has_no_kernel_for():
    q = torch.empty((1, 64, 2, 128), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((1, 2, 64, 1), device="meta")
    before = _build.launch_counts()
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash.flash_attention_bwd(q, q, q, q, lse, q)
    assert _build.launch_counts() == before


@pytest.mark.parametrize("bad", ["lse_shape", "do_dtype", "o_shape"])
def test_backward_input_check_raises_before_any_build(bad):
    """What the backward kernels cannot take meets a check before the
    library is built or a kernel launched (meta tensors: no card needed)."""
    q = torch.empty((1, 64, 2, 128), dtype=torch.bfloat16, device="meta")
    o, do = q, q
    lse = torch.empty((1, 2, 64, 1), device="meta")
    if bad == "lse_shape":
        lse = torch.empty((1, 64, 2, 1), device="meta")
    elif bad == "do_dtype":
        do = torch.empty(q.shape, dtype=torch.float32, device="meta")
    else:
        o = torch.empty((1, 32, 2, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises((TypeError, ValueError)):
        flash._BwdLaunch(q, q, q, o, lse, do, True, 128 ** -0.5)


def test_kernel_readable_layouts():
    """The gradient autograd hands the backward may have any strides: the
    kernels read a permuted layout by its strides; a strided last dim or a
    misaligned bf16 row is copied first."""
    t = torch.empty((2, 64, 4, 128), dtype=torch.bfloat16)
    assert flash._kernel_readable(t)
    assert flash._kernel_readable(t.transpose(1, 2).contiguous().transpose(1, 2))
    assert not flash._kernel_readable(torch.empty((2, 64, 4, 256), dtype=torch.bfloat16)[..., ::2])
    assert not flash._kernel_readable(torch.empty((2 * 64 * 4 * 128 + 1,), dtype=torch.bfloat16)[1:]
                                      .view(2, 64, 4, 128))
    # Strides of size-1 dims are never used.
    assert flash._kernel_readable(torch.empty((1, 64, 4, 128), dtype=torch.bfloat16)
                                  .as_strided((1, 64, 4, 128), (3, 512, 128, 1)))
