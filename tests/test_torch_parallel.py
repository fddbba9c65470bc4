"""The port's meshes, sharding rules and collectives (`ray_tpu_torch.parallel`)
against the JAX package's (`ray_tpu.parallel`), and their multi-rank
behaviour on 4 CPU processes joined in a gloo group.

The pure logic (MeshSpec, the presets, `_fit_spec`) is compared with the
JAX functions here; one run of the 4 ranks (module fixture) does the
rest: shard/gather round trips, fsdp's memory at rest, what remat keeps
from one layer to the next under fsdp, and the collectives' values and
gradients. The ranks import no jax (this module imports it only inside
functions).
"""

import multiprocessing
import os
import subprocess
import sys
import time

import pytest
import torch

from ray_tpu_torch.models import (
    LMTrainContext,
    TransformerConfig,
    forward,
    init_params,
    param_axes,
)
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models.transformer import param_shapes
from ray_tpu_torch.parallel import (
    PRESETS,
    MeshBootstrap,
    MeshSpec,
    build_mesh,
    copy_to,
    device_allreduce,
    gather_from,
    gather_shards,
    gather_tree,
    local_placements,
    logical_to_spec,
    pick_coordinator_address,
    reduce_from,
    remesh_spec,
    resolve_rules,
    setup_mesh,
    shard_tree,
)
from ray_tpu_torch.parallel.sharding import _fit_spec, placement, tree_leaves
from torch_ranks import run_local_ranks

WORLD = 4
SPECS = [
    dict(), dict(data=2), dict(data=-1, tensor=2), dict(fsdp=-1), dict(data=2, fsdp=2),
    dict(data=1, seq=4), dict(data=2, seq=2, tensor=2), dict(data=-1, tensor=-1),
    dict(data=3), dict(data=-1, tensor=3), dict(fsdp=2, expert=2, pipeline=2),
]
DEVICE_COUNTS = [1, 4, 6, 8]


def _jax_parallel():
    import ray_tpu.parallel as jax_parallel

    return jax_parallel


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_mesh_spec_resolve_and_remesh_match_jax(spec):
    jp = _jax_parallel()
    for n in DEVICE_COUNTS:
        ours, theirs = MeshSpec(**spec), jp.MeshSpec(**spec)
        for fn in ("resolve", "remesh"):
            a = _outcome(lambda: ours.resolve(n) if fn == "resolve" else remesh_spec(ours, n))
            b = _outcome(lambda: theirs.resolve(n) if fn == "resolve" else jp.remesh_spec(theirs, n))
            if isinstance(b, tuple):
                assert a == b, (fn, n)
            else:
                assert (a.shape(), a.size(), a.axis_names) == (b.shape(), b.size(), b.axis_names)


def test_presets_are_the_jax_presets():
    jp = _jax_parallel()
    assert sorted(PRESETS) == sorted(jp.PRESETS)
    for name in PRESETS:
        assert resolve_rules(name) == jp.resolve_rules(name), name
    with pytest.raises(ValueError, match="unknown strategy"):
        resolve_rules("zero3")


# (mesh, shape, logical axes) under every preset.
FIT_CASES = [
    (dict(data=2, fsdp=4), (256, 64), ("vocab", "embed")),
    (dict(data=2, tensor=4), (2, 64, 2, 16), ("layers", "embed", "kv_heads", "head_dim")),
    (dict(data=2, tensor=4), (2, 64, 4, 16), ("layers", "embed", "heads", "head_dim")),
    (dict(fsdp=2, tensor=4), (2, 48, 6, 16), ("layers", "embed", "heads", "head_dim")),
    (dict(data=2, fsdp=2, tensor=2), (8, 32), ("act_batch", "act_seq")),
    (dict(data=4, fsdp=2), (6, 32), ("act_batch", "act_seq")),
    (dict(data=2, seq=4), (3, 32, 8), ("act_batch", "act_seq", "act_vocab")),
    (dict(pipeline=2, fsdp=4), (3, 64, 128), ("layers", "embed", "mlp")),
]


@pytest.mark.parametrize("case", range(len(FIT_CASES)))
def test_fit_spec_matches_jax(case):
    import jax

    jp = _jax_parallel()
    from ray_tpu.parallel.sharding import _fit_spec as jax_fit_spec

    spec_kw, shape, axes = FIT_CASES[case]
    jax_mesh = jp.build_mesh(jp.MeshSpec(**spec_kw), devices=jax.devices()[:8])
    sizes = jp.mesh_axis_sizes(jax_mesh)
    for name in PRESETS:
        rules = resolve_rules(name)
        ours = _fit_spec(shape, logical_to_spec(axes, rules), sizes)
        theirs = jax_fit_spec(shape, jp.logical_to_spec(axes, rules), jax_mesh)
        assert ours == tuple(theirs) + (None,) * (len(shape) - len(theirs)), name


def test_placement_drops_axes_of_size_one():
    sizes = {"data": 1, "fsdp": 2, "expert": 1, "pipeline": 1, "seq": 1, "tensor": 4}
    rules = resolve_rules("fsdp_tp")
    assert placement((64, 2, 16), ("embed", "kv_heads", "head_dim"), rules, sizes) == (
        ("fsdp",), (), ())  # GQA kv heads 2 stay whole under tensor=4
    assert placement((8, 32), ("act_batch", "act_seq"), rules, sizes) == (("fsdp",), ())


# -- on 4 ranks -------------------------------------------------------------

ROUND_TRIPS = [("fsdp", dict(data=2, fsdp=2)), ("tp", dict(data=1, tensor=4)),
               ("fsdp_tp", dict(data=1, fsdp=2, tensor=2)), ("sp", dict(data=1, seq=2, tensor=2))]
CFG = TransformerConfig.tiny(remat=True)


def _storages(obj, out):
    if isinstance(obj, torch.Tensor):
        out.add(obj.untyped_storage().data_ptr())
    elif isinstance(obj, dict):
        for v in obj.values():
            _storages(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _storages(v, out)
    return out


def _kept_layer_weights(params, tokens, cfg, rules, mesh):
    """(how many, of how many) layer weights put together by a training
    forward (fsdp's all-gathers) it keeps for the backward: as the input of
    a remat segment, or saved outside the segments. The assembled weights
    are held until the count, so no other tensor takes their memory."""
    assembled, kept = [], set()
    layer_weights, segment = transformer._layer_weights, transformer._checkpoint

    def assembling(*args):
        ws = layer_weights(*args)
        assembled.extend(ws)
        return ws

    def recording(fn, *args):
        _storages(args, kept)
        return segment(fn, *args)

    def pack(t):
        kept.add(t.untyped_storage().data_ptr())
        return t

    transformer._layer_weights, transformer._checkpoint = assembling, recording
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            logits = forward(params, tokens, cfg, rules=rules, mesh=mesh)
    finally:
        transformer._layer_weights, transformer._checkpoint = layer_weights, segment
    ptrs = _storages(assembled, set())
    del logits
    return len(ptrs & kept), len(ptrs)


def _ranks(rank, out_dir):
    out = {}
    full = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    for name, spec in ROUND_TRIPS:
        mesh = build_mesh(MeshSpec(**spec), device_type="cpu")
        rules = resolve_rules(name)
        local = shard_tree(full, param_axes(CFG), rules, mesh)
        places = local_placements(param_shapes(CFG), param_axes(CFG), rules, mesh)
        back = gather_tree(local, places, mesh)
        out[f"round_trip_{name}"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(full)))
        if name == "fsdp":
            wq = local["layers"]["attn"]["wq"]
            out["fsdp_wq_bytes"] = (wq.numel() * wq.element_size(),
                                    full["layers"]["attn"]["wq"].numel() * wq.element_size())
            tokens = torch.randint(0, CFG.vocab_size, (2, 16), generator=torch.Generator()
                                   .manual_seed(rank))
            for leaf in tree_leaves(local):
                leaf.requires_grad_(True)
            for policy in (None, "qkv_attn"):
                cfg = TransformerConfig.tiny(remat=True, remat_policy=policy)
                out[f"kept_remat_{policy}"] = _kept_layer_weights(local, tokens, cfg, rules, mesh)
            out["kept_no_remat"] = _kept_layer_weights(local, tokens, TransformerConfig.tiny(),
                                                       rules, mesh)
            plan = transformer._sharded(CFG, rules, mesh)
            out["plan_built_once"] = (
                transformer._sharded(CFG, dict(rules), mesh) is plan
                and LMTrainContext(CFG, mesh, name).placements is plan.places
                and plan.places == places)
        del mesh
    # Collectives over the tensor axis of a 2 x 2 mesh.
    mesh = build_mesh(MeshSpec(data=2, tensor=2), device_type="cpu")
    group = mesh.get_group("tensor")
    x = torch.tensor([float(rank + 1)])
    out["allreduce"] = {op: device_allreduce(x, mesh, "tensor", op).item()
                        for op in ("sum", "mean", "max", "min")}
    grads = {}
    for name, fn in (("copy_to", lambda t: copy_to(t, group)),
                     ("reduce_from", lambda t: reduce_from(t, group)),
                     ("gather_from", lambda t: gather_from(t, group, 0)),
                     ("gather_shards", lambda t: gather_shards(t, group, 0))):
        t = torch.ones(2, requires_grad=True)
        y = fn(t)
        # A downstream replicated over the tensor axis (the same loss on
        # both ranks), except for gather_shards, whose callers' losses
        # differ by rank (fsdp's batch split).
        (y * (rank + 1 if name == "gather_shards" else 1)).sum().backward()
        grads[name] = t.grad.tolist()
        out[f"{name}_value"] = y.detach().tolist()
    out["grads"] = grads
    torch.save(out, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    run_local_ranks(_ranks, WORLD, (str(tmp),), init_file=str(tmp / "rdzv"))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("strategy", [n for n, _ in ROUND_TRIPS])
def test_shard_gather_round_trip_is_bit_exact(results, strategy):
    assert all(out[f"round_trip_{strategy}"] for out in results)


def test_fsdp_rank_holds_half_of_wq(results):
    """data=2, fsdp=2: wq [L, E, H, Dh] splits E over fsdp."""
    for out in results:
        local, full = out["fsdp_wq_bytes"]
        assert 2 * local == full


@pytest.mark.parametrize("policy", [None, "qkv_attn"])
def test_fsdp_remat_keeps_no_full_layer_weight(results, policy):
    """Under fsdp with remat each layer's weights are gathered inside the
    segment that uses them: none of the 2 layers x 7 gathered weights is a
    segment's input or saved outside the segments. Without remat the
    products save 6 of each layer's 7 themselves (wo's einsum saves a
    permuted copy instead), which shows the check sees them."""
    n_weights = 2 * 7
    for out in results:
        assert out[f"kept_remat_{policy}"] == (0, n_weights)
        assert out["kept_no_remat"] == (2 * 6, n_weights)


def test_sharding_plan_is_built_once_per_mesh(results):
    """The forward's plan of a (config, rules, mesh) is built at its first
    use and shared, placements included, with LMTrainContext."""
    assert all(out["plan_built_once"] for out in results)


def test_device_allreduce_over_an_axis(results):
    # tensor pairs ranks (0, 1) and (2, 3).
    for rank, out in enumerate(results):
        pair = (1.0, 2.0) if rank < 2 else (3.0, 4.0)
        assert out["allreduce"] == {"sum": sum(pair), "mean": sum(pair) / 2,
                                    "max": max(pair), "min": min(pair)}


def test_autograd_collectives_place_the_sums(results):
    """Megatron's f and g over the tensor axis: a replicated downstream
    gives f's input the sum of the two ranks' (equal) partial gradients,
    g's input the gradient once (torch.distributed.nn's all_reduce would
    give 2); the split backward of gather_from takes the rank's slice;
    gather_shards' backward sums the ranks' different gradients."""
    for rank, out in enumerate(results):
        pair = (1.0, 2.0) if rank < 2 else (3.0, 4.0)
        assert out["grads"]["copy_to"] == [2.0, 2.0]
        assert out["grads"]["reduce_from"] == [1.0, 1.0]
        assert out["reduce_from_value"] == [2.0, 2.0]
        assert out["grads"]["gather_from"] == [1.0, 1.0]
        assert out["gather_from_value"] == [1.0] * 4
        assert out["grads"]["gather_shards"] == [sum(pair)] * 2


def _raise(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(30)  # the others would wait on it in a collective


def _hang(rank, pid_dir):
    open(os.path.join(pid_dir, f"{os.getpid()}"), "w").close()
    time.sleep(120)


def test_run_local_ranks_raises_a_rank_failure_and_stops_the_rest(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        run_local_ranks(_raise, 2, init_file=str(tmp_path / "rdzv"))
    assert time.monotonic() - t0 < 25


def test_run_local_ranks_stops_hung_ranks_at_the_deadline(tmp_path):
    pids = tmp_path / "pids"
    pids.mkdir()
    with pytest.raises(TimeoutError):
        run_local_ranks(_hang, 2, (str(pids),), init_file=str(tmp_path / "rdzv"),
                        deadline_s=3.0)
    for pid in (int(p.name) for p in pids.iterdir()):
        with pytest.raises(ProcessLookupError):
            for _ in range(50):  # reaped within the join's grace
                os.kill(pid, 0)
                time.sleep(0.1)


def test_build_mesh_makes_a_one_rank_group_when_none_exists():
    """A process with no process group gets the one-rank mesh, every
    canonical axis a dimension of size 1 (run in a fresh interpreter: the
    group is process-wide)."""
    code = ("from ray_tpu_torch.parallel import build_mesh, mesh_axis_sizes;"
            "m = build_mesh(device_type='cpu'); print(mesh_axis_sizes(m))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == str(
        {"data": 1, "fsdp": 1, "expert": 1, "pipeline": 1, "seq": 1, "tensor": 1})


def _bootstrap_rank(rank, address, out_dir):
    boot = MeshBootstrap(num_processes=2, process_id=rank, coordinator_address=address,
                         device_type="cpu")
    mesh = setup_mesh(MeshSpec(data=2), boot)
    total = device_allreduce(torch.tensor([rank + 1.0]), mesh, "data").item()
    boot.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}"), "w") as f:
        f.write(f"{total} {torch.distributed.is_initialized()}")


def test_mesh_bootstrap_joins_two_processes_over_tcp(tmp_path, monkeypatch):
    """MeshBootstrap joins the processes through the coordinator rank 0
    picks, setup_mesh builds the mesh over them, shutdown leaves; one
    process alone (or one that never joined) needs neither."""
    MeshBootstrap().initialize()
    MeshBootstrap(num_processes=2).shutdown()
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("RAY_TPU_HOST_IP", "127.0.0.1")
    address = pick_coordinator_address()
    assert address.startswith("127.0.0.1:") and int(address.split(":")[1]) > 0
    ctx = multiprocessing.get_context("forkserver")
    procs = [ctx.Process(target=_bootstrap_rank, args=(r, address, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
    assert not alive and [p.exitcode for p in procs] == [0, 0]
    assert [(tmp_path / f"rank{r}").read_text() for r in range(2)] == ["3.0 False"] * 2
