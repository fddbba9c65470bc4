"""The port's runtime is a copy of the JAX package's, package name rewritten.

`ray_tpu_torch` keeps its own copy of the actor runtime (`ray_tpu/` minus
its compute layer: `_private/`, `_native/`, `util/`, the top-level API
modules), of the data and train libraries, of the serve stack and the AIR
batch predictor, of the RL library's offline reader and policy server, and
of the ML libraries and bridges over the runtime (tune, workflows, the
torch trainer's package, the multiprocessing and joblib shims), of the
cluster layer (jobs, the cluster fixture, the autoscaler, the CLI and the
runtime's microbenchmarks) and of the static-analysis lint with its data
files and script, so that it imports nothing of `ray_tpu`. The copy is the source with one rule applied, `\\bray_tpu\\b` ->
`ray_tpu_torch`, and differs from it only in the ported definitions named
in PORTED below. These tests recompute what the copy must hold from the
source tree, and hold every copied module to its source line for line, so
that the JAX package's runtime tests and lint, which hold the source, hold
the copy too.
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SRC, PORT = "ray_tpu", "ray_tpu_torch"

# The runtime: the public API module, actors and remote functions, and
# everything they import, at module level or inside functions, plus the
# modules the runtime starts with `python -m`.
RUNTIME_SEEDS = ("ray_tpu", "ray_tpu.actor", "ray_tpu.remote_function")
# The data and train libraries copied with it (their other imports, the
# compute layer and `air.checkpoint`, are the port's own).
TRAINER_MODULES = (
    "ray_tpu.data", "ray_tpu.data.block", "ray_tpu.data.datasource", "ray_tpu.data.read_api",
    "ray_tpu.data.dataset", "ray_tpu.train", "ray_tpu.train.session",
    "ray_tpu.train.worker_group", "ray_tpu.train.backend_executor", "ray_tpu.train.backend",
    "ray_tpu.train.data_parallel_trainer", "ray_tpu.air", "ray_tpu.air.config",
    "ray_tpu.air.result",
)
# The serve stack and the AIR batch predictor, with the `air` package that
# exports them (their other imports are the runtime's and the port's own
# `air.checkpoint`).
SERVE_MODULES = (
    "ray_tpu.serve", "ray_tpu.serve.config", "ray_tpu.serve.replica",
    "ray_tpu.serve.controller", "ray_tpu.serve.router", "ray_tpu.serve.http_proxy",
    "ray_tpu.serve.api", "ray_tpu.serve.batching", "ray_tpu.air.preprocessors",
    "ray_tpu.air.batch_predictor",
)
# The RL library's modules that hold no JAX (its learners and algorithm
# classes are the port's own).
RLLIB_MODULES = ("ray_tpu.rllib.offline", "ray_tpu.rllib.policy_client")
# The ML libraries and bridges over the runtime: tune, workflows, the torch
# trainer's package and the multiprocessing and joblib shims.
LIBRARY_MODULES = (
    "ray_tpu.tune", "ray_tpu.tune.trial", "ray_tpu.tune.search", "ray_tpu.tune.schedulers",
    "ray_tpu.tune.trial_runner", "ray_tpu.tune.tuner", "ray_tpu.workflow",
    "ray_tpu.train.torch", "ray_tpu.train.torch.config", "ray_tpu.train.torch.torch_trainer",
    "ray_tpu.train.torch.train_loop_utils", "ray_tpu.util.multiprocessing",
    "ray_tpu.util.joblib",
)
# The cluster layer: job submission, the in-process cluster fixture, the
# autoscaler, the CLI and the microbenchmarks the CLI runs.
CLUSTER_MODULES = (
    "ray_tpu.job_submission", "ray_tpu.cluster_utils", "ray_tpu.autoscaler",
    "ray_tpu.autoscaler.autoscaler", "ray_tpu.autoscaler.node_provider",
    "ray_tpu._private.ray_perf", "ray_tpu.scripts", "ray_tpu.scripts.cli",
)
# The static-analysis lint: its 14 modules, its data files (the reviewed
# allowlist and the four generated catalogs, held as text) and its script.
ANALYSIS_MODULES = tuple(
    f"ray_tpu._private.analysis{'' if p.stem == '__init__' else '.' + p.stem}"
    for p in sorted((REPO / SRC / "_private" / "analysis").glob("*.py"))
)
ANALYSIS_CATALOGS = ("fault_points.txt", "knob_names.txt", "metric_names.txt", "span_names.txt")

# Where the copy differs from its rewritten source: (port module, the
# definition as the port names it, its name in the source, why). "*" is a
# whole module; "<doc>" the module docstring; "import:<module>" the import
# from that module; "<function>:<target>" the statement in the function
# that assigns <target>, and the `if` after it if one follows. A source name
# of None is a definition the source lacks: it is left out of the copy
# before the comparison.
PORTED = [
    ("ray_tpu_torch._private.runtime", "_detect_gpus", "_detect_tpu_chips",
     "counts the NVIDIA cards this process may open (/dev/nvidia<N>, limited by "
     "CUDA_VISIBLE_DEVICES) where the source counts TPU chips (/dev/accel*); the "
     "RAY_TPU_CHIPS override stays"),
    ("ray_tpu_torch._private.runtime", "Runtime.__init__:gpus", "Runtime.__init__:chips",
     "registers the detected cards as the \"GPU\" resource in place of \"TPU\""),
    ("ray_tpu_torch", "<doc>", "<doc>",
     "the port's docstring; the runtime API below it is the source's"),
    ("ray_tpu_torch.air.config", "<doc>", "<doc>", "says what ScalingConfig reserves"),
    ("ray_tpu_torch.air.config", "ScalingConfig", "ScalingConfig",
     "use_gpu reserves one \"GPU\" a worker, as Ray's does, where use_tpu/chips_per_worker "
     "reserve \"TPU\"; the source's mesh_shape, which nothing reads, is left out"),
    ("ray_tpu_torch.air.batch_predictor", "BatchPredictor.predict", "BatchPredictor.predict",
     "num_gpus_per_actor reserves \"GPU\" for each predictor actor where the source's "
     "num_tpus_per_actor reserves \"TPU\""),
    ("ray_tpu_torch.train.backend", "*", "*",
     "TorchConfig joins a torch.distributed group where JaxConfig joins jax.distributed"),
    ("ray_tpu_torch.train.data_parallel_trainer", "import:ray_tpu_torch.train.backend",
     "import:ray_tpu_torch.train.backend", "imports TorchConfig, the default backend"),
    ("ray_tpu_torch.train.data_parallel_trainer",
     "DataParallelTrainer.__init__:self.backend_config",
     "DataParallelTrainer.__init__:self.backend_config",
     "the default backend is TorchConfig(), and its scaling config reserves a \"GPU\" for "
     "each worker that binds a card"),
    ("ray_tpu_torch.train.data_parallel_trainer", "TorchTrainer", "JaxTrainer",
     "TorchTrainer presets TorchConfig where JaxTrainer presets JaxConfig"),
    ("ray_tpu_torch.train", "*", "*",
     "the same names with TorchConfig/TorchTrainer in place of JaxConfig/JaxTrainer"),
    # Card ids (gpu_ids.py): a whole-"GPU" grant takes distinct ids, its
    # worker sees them as its CUDA_VISIBLE_DEVICES, and they go back with its
    # resources. The JAX runtime assigns no chip ids, so none of this can
    # come from the source.
    ("ray_tpu_torch._private.scheduler", "Scheduler.__init__", "Scheduler.__init__",
     "holds the card ids of the grants (GpuIds)"),
    ("ray_tpu_torch._private.runtime", "Runtime._dispatch_placed", "Runtime._dispatch_placed",
     "takes a whole-\"GPU\" grant's card ids, leases a worker whose runtime env names those "
     "cards, and records the lease, actor or task that holds them"),
    ("ray_tpu_torch._private.runtime", "Runtime._release_for", "Runtime._release_for",
     "gives a task's card ids back with its resources"),
    ("ray_tpu_torch._private.runtime", "Runtime._release_actor_placement",
     "Runtime._release_actor_placement", "gives an actor's card ids back with its placement"),
    ("ray_tpu_torch._private.runtime", "Runtime._revoke_lease_locked",
     "Runtime._revoke_lease_locked", "gives a lease's card ids back with its resources"),
    ("ray_tpu_torch._private.runtime", "Runtime._req_lease_worker", "Runtime._req_lease_worker",
     "a worker's lease of whole \"GPU\"s takes card ids as a dispatch from the head does"),
    ("ray_tpu_torch._private.runtime", "Runtime._release_peer_lease_locked",
     "Runtime._release_peer_lease_locked", "gives a worker lease's card ids back"),
    ("ray_tpu_torch", "get_gpu_ids", None,
     "ray.get_gpu_ids(): the card ids of a worker's grant"),
    ("ray_tpu_torch.train.torch.config", "*", "*",
     "names the port's one TorchConfig (train/backend.py), whose device=\"cpu\" joins the "
     "gloo group that the source's second TorchConfig(backend=\"gloo\") joins"),
    ("ray_tpu_torch.train.torch.train_loop_utils", "prepare_model", "prepare_model",
     "moves the model to the worker's device, the card the backend bound or the CPU, and "
     "gives DDP that card, where the source's gloo-only path leaves it on the CPU"),
    ("ray_tpu_torch.scripts.cli", "cmd_bench", "cmd_bench",
     "runs bench_torch.py, the port's twin of bench.py (the head configuration and the "
     "long-context sweep on the card), where the source runs the JAX package's bench.py"),
]


def _rewrite(text: str) -> str:
    return re.sub(r"\bray_tpu\b", PORT, text)


def _path(module: str, root: Path = REPO):
    base = root / module.replace(".", "/")
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.is_file():
            return p
    return None


def _imports(module: str, path: Path):
    """The package's modules that `module` imports anywhere in its body,
    with their parent packages, and the modules it starts with `-m`."""
    tree = ast.parse(path.read_text())
    package = module if path.name == "__init__.py" else module.rpartition(".")[0]
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")
                base = ".".join(parts[:len(parts) - node.level + 1])
                name = f"{base}.{node.module}" if node.module else base
            else:
                name = node.module or ""
            found.add(name)
            found.update(f"{name}.{a.name}" for a in node.names)
        elif isinstance(node, ast.List):
            items = [e.value if isinstance(e, ast.Constant) else None for e in node.elts]
            found.update(b for a, b in zip(items, items[1:]) if a == "-m" and isinstance(b, str))
    out = set()
    for name in found:
        if name.split(".")[0] != SRC or _path(name) is None:
            continue
        parts = name.split(".")
        out.update(".".join(parts[:i]) for i in range(1, len(parts) + 1))
    return out


def runtime_closure():
    seen, todo = set(), list(RUNTIME_SEEDS)
    while todo:
        module = todo.pop()
        if module in seen:
            continue
        seen.add(module)
        todo.extend(_imports(module, _path(module)))
    return seen


def _port_name(module: str) -> str:
    return _rewrite(module)


def _node_span(tree: ast.Module, qualname: str):
    """First and last line (1-based) of a definition, decorators included."""
    if qualname == "<doc>":
        node = tree.body[0]
        assert isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)
        return node.lineno, node.end_lineno
    if qualname.startswith("import:"):
        name = qualname.split(":", 1)[1]
        (node,) = [n for n in tree.body if isinstance(n, ast.ImportFrom) and n.module == name]
        return node.lineno, node.end_lineno
    qualname, _, assigned = qualname.partition(":")
    body = tree.body
    node = None
    for part in qualname.split("."):
        (node,) = [n for n in body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                   and n.name == part]
        body = node.body
    if assigned:
        (i,) = [i for i, n in enumerate(body) if isinstance(n, ast.Assign)
                and [ast.unparse(t) for t in n.targets] == [assigned]]
        end = body[i + 1] if isinstance(body[i + 1], ast.If) else body[i]
        return body[i].lineno, end.end_lineno
    start = min([node.lineno] + [d.lineno for d in node.decorator_list])
    return start, node.end_lineno


def _masked(text: str, spans) -> list:
    """The text's lines with each span replaced by one marker line, or left
    out, with the blank lines before it, where its label is None."""
    lines = text.splitlines()
    for (start, end), label in sorted(spans, key=lambda s: s[0], reverse=True):
        while label is None and start > 1 and not lines[start - 2].strip():
            start -= 1
        lines[start - 1:end] = [] if label is None else [f"<ported {label}>"]
    return lines


def _copied_modules():
    return sorted(runtime_closure() | set(TRAINER_MODULES) | set(SERVE_MODULES)
                  | set(RLLIB_MODULES) | set(LIBRARY_MODULES) | set(CLUSTER_MODULES)
                  | set(ANALYSIS_MODULES))


def test_closure_is_the_runtime_and_every_module_has_its_copy():
    closure = runtime_closure()
    # The modules the runtime starts as processes are in it, and nothing of
    # the compute layer is.
    assert {"ray_tpu._private.worker_proc", "ray_tpu._private.zygote", "ray_tpu._private.head",
            "ray_tpu._private.node_daemon", "ray_tpu._private.io_shard"} <= closure
    assert not {m for m in closure if m.split(".")[1:2] in (["parallel"], ["models"], ["ops"],
                                                            ["train"], ["air"])}
    assert len(closure) >= 50
    missing = [m for m in _copied_modules() if _path(_port_name(m)) is None]
    assert missing == []


def test_every_module_the_copies_import_is_in_the_port():
    imported = set().union(*(_imports(m, _path(m)) for m in _copied_modules()))
    assert {"ray_tpu._private.pubsub", "ray_tpu.util.tracing", "ray_tpu.air.checkpoint",
            "ray_tpu.data.block", "ray_tpu.train.session"} <= imported
    assert [m for m in sorted(imported) if _path(_port_name(m)) is None] == []


@pytest.mark.parametrize("module", _copied_modules())
def test_copy_equals_its_source_outside_the_ported_definitions(module):
    port = _port_name(module)
    ported = [(p, s) for m, p, s, _ in PORTED if m == port]
    if ("*", "*") in ported:
        return
    src_text = _rewrite(_path(module).read_text())
    port_text = _path(port).read_text()
    src_tree, port_tree = ast.parse(src_text), ast.parse(port_text)
    src = _masked(src_text, [(_node_span(src_tree, s), p) for p, s in ported if s is not None])
    dst = _masked(port_text, [(_node_span(port_tree, p), p if s is not None else None)
                              for p, s in ported])
    diff = [(i + 1, a, b) for i, (a, b) in enumerate(zip(src, dst)) if a != b]
    assert diff[:3] == [] and len(src) == len(dst), f"{port} differs from {module}"


def _definition(path: Path, name: str, rewrite: bool) -> list:
    text = _rewrite(path.read_text()) if rewrite else path.read_text()
    start, end = _node_span(ast.parse(text), name)
    return text.splitlines()[start - 1:end]


def test_ported_definitions_are_few_and_exist():
    assert len(PORTED) <= 22
    for port, name, _, reason in PORTED:
        assert reason
        if name != "*":
            _node_span(ast.parse(_path(port).read_text()), name)


@pytest.mark.parametrize("row", [r for r in PORTED if r[1] != "*" and r[2] is not None],
                         ids=lambda r: f"{r[0]}:{r[1]}")
def test_a_ported_definition_differs_from_its_source(row):
    """A row names a definition the port changed: one equal to its
    rewritten source would hide a copy that lost its port."""
    port, name, src_name, _ = row
    src = _path(port.replace(PORT, SRC, 1))
    assert _definition(_path(port), name, False) != _definition(src, src_name, True)


def test_native_arena_source_is_identical():
    src = (REPO / SRC / "_native" / "shm_arena.cpp").read_bytes()
    assert (REPO / PORT / "_native" / "shm_arena.cpp").read_bytes() == src


def test_analysis_modules_are_the_lint_s_fourteen():
    assert len(ANALYSIS_MODULES) == 14
    assert {"ray_tpu._private.analysis", "ray_tpu._private.analysis.blocking",
            "ray_tpu._private.analysis.wire_schema"} <= set(ANALYSIS_MODULES)


# Spans the port opens in code that has no source (the training step, the
# kernel loader), in the span catalog beside the source's, each with why.
PORT_SPANS = {
    "lm::train_step": "models/lm.py: one training step, the root of its phases",
    "lm::forward": "models/lm.py: the step's forward (embedding, layers, head)",
    "lm::loss": "models/lm.py: the step's cross entropy, or a rank's share under a mesh",
    "lm::backward": "models/lm.py: torch.autograd.grad over the leaves, remat's recompute "
                    "included",
    "lm::grad_norm": "models/lm.py: the gradients' global norm, with their sums and the "
                     "loss's under a mesh",
    "lm::optimizer": "models/lm.py: the optimizer's update (clip and AdamW)",
    "cuda::load_library": "ops/cuda/_build.py: a CUDA library's first load in the process, "
                          "nvcc included where it builds",
}


# Metrics the port records in code that has no source, in the metric catalog
# beside the source's ("<name> <Type>" lines), each with why.
PORT_METRICS = {
    "cuda_kernel_launches Counter": "ops/cuda/_build.py: successful launches of the port's "
                                    "hand-written CUDA kernels, by C entry point",
}


@pytest.mark.parametrize("name", ANALYSIS_CATALOGS)
def test_generated_catalog_is_its_source_s_rewritten(name):
    """The four catalogs, regenerated over the port's tree, name the same
    fault points, metrics, spans and knobs as the source's over its own;
    the span and metric catalogs name the port's own spans (PORT_SPANS) and
    metrics (PORT_METRICS) besides."""
    src = _rewrite((REPO / SRC / "_private" / "analysis" / name).read_text()).splitlines()
    own = {"span_names.txt": PORT_SPANS, "metric_names.txt": PORT_METRICS}.get(name)
    if own:
        header = [ln for ln in src if ln.startswith("#")]
        names = [ln for ln in src if ln and not ln.startswith("#")]
        assert not set(names) & set(own)
        src = header + sorted(names + list(own))
    assert all(PORT_SPANS.values()) and all(PORT_METRICS.values())
    port = (REPO / PORT / "_private" / "analysis" / name).read_text().splitlines()
    assert port == src


def _allowlist(path: Path) -> dict:
    lines = [ln for ln in path.read_text().splitlines() if ln.strip() and not ln.startswith("#")]
    return dict(ln.split(" | ", 1) for ln in lines)


def test_allowlist_holds_its_source_s_entries_and_reviews_only_port_files():
    """Every reviewed site of the source is the copy's, with its
    justification; an entry the source lacks names a file of the port that
    has no source (the kernels, the models, card ids), never a copied one."""
    src = {_rewrite(k): v for k, v in
           _allowlist(REPO / SRC / "_private" / "analysis" / "allowlist.txt").items()}
    port = _allowlist(REPO / PORT / "_private" / "analysis" / "allowlist.txt")
    assert {k: port.get(k) for k in src} == src
    for key in set(port) - set(src):
        path = key.split(":")[1]
        assert path.startswith(PORT + "/") and (REPO / path).is_file(), key
        assert not (REPO / SRC / path[len(PORT) + 1:]).exists(), key
        assert port[key] and "TODO" not in port[key], key
