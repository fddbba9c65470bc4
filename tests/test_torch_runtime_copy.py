"""The port's runtime is a copy of the JAX package's, package name rewritten.

`ray_tpu_torch` keeps its own copy of the actor runtime (`ray_tpu/` minus
its compute layer: `_private/`, `_native/`, `util/`, the top-level API
modules), of the data and train libraries, and of the serve stack and the
AIR batch predictor, so that it imports nothing of `ray_tpu`. The copy is the source with one rule applied, `\\bray_tpu\\b` ->
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

# Where the copy differs from its rewritten source: (port module, the
# definition as the port names it, its name in the source, why). "*" is a
# whole module; "<doc>" the module docstring; "import:<module>" the import
# from that module; "<function>:<target>" the statement in the function
# that assigns <target>, and the `if` after it if one follows.
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
    """The text's lines with each span replaced by one marker line."""
    lines = text.splitlines()
    for (start, end), label in sorted(spans, reverse=True):
        lines[start - 1:end] = [f"<ported {label}>"]
    return lines


def _copied_modules():
    return sorted(runtime_closure() | set(TRAINER_MODULES) | set(SERVE_MODULES))


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
    src = _masked(src_text, [(_node_span(src_tree, s), p) for p, s in ported])
    dst = _masked(port_text, [(_node_span(port_tree, p), p) for p, _ in ported])
    diff = [(i + 1, a, b) for i, (a, b) in enumerate(zip(src, dst)) if a != b]
    assert diff[:3] == [] and len(src) == len(dst), f"{port} differs from {module}"


def test_ported_definitions_are_few_and_exist():
    assert len(PORTED) <= 11
    for port, name, _, reason in PORTED:
        assert reason
        if name != "*":
            _node_span(ast.parse(_path(port).read_text()), name)


def test_native_arena_source_is_identical():
    src = (REPO / SRC / "_native" / "shm_arena.cpp").read_bytes()
    assert (REPO / PORT / "_native" / "shm_arena.cpp").read_bytes() == src
