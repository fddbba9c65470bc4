"""BENCHMARK.json keeps to its contract, every configuration's cut
(`reduced`) has the form a cut must have, and every cell's files are found
by name: adding a cell, a configuration of another model family cut to one
card's share, or a metric that reads the program's spans and counters adds
files and entries and edits none."""

import hashlib
import json
import re
import shutil
import time

import pytest

from benchmark import manifest, run, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and BENCH["command"][1] == "benchmark/run.py"
    # A full check of 24 cells fits the driver's 43,200 seconds.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert (manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_keys():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_and_reports_enough(cell):
    c = manifest.workload(cell, BENCH)
    m = manifest.config(c["config"])
    assert m["name"] == c["config"]
    assert hasattr(manifest.kind(c["kind"]), "run")
    e2e = [x["name"] for x in manifest.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.per_layer(BENCH, cell)
    assert layer
    for metric in layer:
        assert callable(manifest.reader(metric["name"]).read)
        assert metric["moves"] in e2e


# Keys that are widths (a hidden, intermediate, latent, state or projection
# size, a head size, an expansion factor, experts per token): never cut.
WIDTH = re.compile(r"(_size|_dim|_rank|_factor|expand|per_tok|top_k)$")


def _is_width(key: str) -> bool:
    return key != "vocab_size" and bool(WIDTH.search(key))


def _is_expert_count(key: str) -> bool:
    return key.endswith("experts") and "shared" not in key


def cut_faults(reduced, m: dict):
    """What is wrong with configuration file `m` cut as `reduced` lists:
    each entry names a key of the file whose value differs from the one
    published, which the file states under "published"; "deployment" gives
    the chips that share a layer ("chips") and how ("how"); no width is cut,
    not even inside a listed group; an expert count keeps at least 8; a
    vocabulary keeps at least an eighth."""
    faults = []
    if len(reduced) > 16 or len(set(reduced)) != len(reduced):
        faults.append("reduced has more than 16 keys or a key twice")
    if not reduced:
        return faults
    published, deployment = m.get("published"), m.get("deployment")
    if not isinstance(published, dict) or set(published) != set(reduced):
        faults.append("published must give the source's value of each key in reduced, and no other")
        published = published if isinstance(published, dict) else {}
    if not (isinstance(deployment, dict) and isinstance(deployment.get("chips"), int)
            and deployment["chips"] >= 1 and isinstance(deployment.get("how"), str)
            and deployment["how"].strip()):
        faults.append("deployment must give the chips that share a layer and how")
    for key in reduced:
        if not NAME.match(key) or key not in m:
            faults.append(f"{key}: not a key of the file")
            continue
        if _is_width(key):
            faults.append(f"{key}: a width is never cut")
        if key not in published:
            continue
        held, source = m[key], published[key]
        if held == source:
            faults.append(f"{key}: holds the published value")
        if isinstance(held, dict) and isinstance(source, dict):
            faults += [f"{key}.{k}: a width inside the group changed"
                       for k in sorted(set(held) | set(source))
                       if _is_width(k) and held.get(k) != source.get(k)]
        if _is_expert_count(key) and not held >= 8:
            faults.append(f"{key}: fewer than 8 experts held")
        if key == "vocab_size" and not 8 * held >= source:
            faults.append(f"{key}: less than an eighth of the vocabulary held")
    return faults


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    path = manifest.ROOT / entry["file"]
    assert path.parent == manifest.BENCH_DIR / "configs"
    m = json.loads(path.read_text())
    assert m["source"] == entry["source"] and m["name"] == entry["name"]
    assert cut_faults(entry["reduced"], m) == []
    assert (manifest.BENCH_DIR / "families" / f"{m.get('family', 'dense')}.py").is_file()


def test_internlm2_is_not_cut():
    assert next(c for c in BENCH["configs"] if c["name"] == "internlm2-1.8b")["reduced"] == []


# LFM2-8B-A1B as one card's share of a layer split 4 ways by its experts.
CUT = {"num_hidden_layers": 24, "num_experts": 8, "num_experts_per_tok": 4, "vocab_size": 65536,
       "hidden_size": 2048, "moe_intermediate_size": 1792,
       "rope": {"rope_theta": 1000000, "head_dim": 64},
       "published": {"num_experts": 32},
       "deployment": {"chips": 4, "how": "expert parallel: each card holds 8 of a layer's 32"}}


def _cut(reduced=("num_experts",), **change):
    m = json.loads(json.dumps(CUT))
    for key, value in change.items():
        if value is None:
            m.pop(key, None)
        else:
            m[key] = value
    return list(reduced), m


def test_a_well_formed_cut():
    assert cut_faults(*_cut()) == []
    reduced, m = _cut(("num_experts", "vocab_size", "rope"), vocab_size=8192,
                      rope={"rope_theta": 10000, "head_dim": 64})
    m["published"].update(vocab_size=65536, rope={"rope_theta": 1000000, "head_dim": 64})
    assert cut_faults(reduced, m) == []


MALFORMED = {  # case: (reduced, file, the fault found)
    "key not in the file": (*_cut(("num_local_experts",),
                                  published={"num_local_experts": 32}), "not a key"),
    "published value held": (*_cut(num_experts=32), "holds the published value"),
    "no published": (*_cut(published=None), "published must"),
    "published lacks a key": (*_cut(("num_experts", "num_hidden_layers"), num_hidden_layers=12),
                              "published must"),
    "no deployment": (*_cut(deployment=None), "deployment must"),
    "deployment without how": (*_cut(deployment={"chips": 4}), "deployment must"),
    "fewer than 8 experts": (*_cut(num_experts=4), "fewer than 8"),
    "vocabulary under an eighth": (*_cut(("vocab_size",), vocab_size=4096,
                                         published={"vocab_size": 65536}), "an eighth"),
    "a width": (*_cut(("moe_intermediate_size",), moe_intermediate_size=896,
                      published={"moe_intermediate_size": 1792}), "a width is never cut"),
    "experts per token": (*_cut(("num_experts_per_tok",), num_experts_per_tok=2,
                                published={"num_experts_per_tok": 4}), "a width is never cut"),
    "a width inside a group": (*_cut(("rope",), rope={"rope_theta": 10000, "head_dim": 32},
                                     published={"rope": {"rope_theta": 1000000,
                                                         "head_dim": 64}}),
                               "rope.head_dim: a width inside the group"),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_a_malformed_cut_is_refused(case):
    reduced, m, fault = MALFORMED[case]
    found = cut_faults(reduced, m)
    assert any(fault in f for f in found), found


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


# A second family for the copy: a dense decoder whose output head is its
# token embedding, with a tensor that is not trained handed to both sides.
TIED = '''"""A dense decoder whose output head is its token embedding, transposed."""

import torch

from benchmark import inputs
from benchmark.families import dense
from benchmark.reference import mm

TINY = dense.TINY
attention_shape = dense.attention_shape
train_flops_per_token = dense.train_flops_per_token


def fixed(m, seed, device):
    g = torch.Generator(device=device).manual_seed(inputs.derive(seed, "tied"))
    return {"probe": torch.randn(4, generator=g, device=device)}


def _handed(fixed):
    if not fixed or "probe" not in fixed:
        raise ValueError("the family's fixed tensors were not handed over")


def program_config(m, cell, fixed=None):
    _handed(fixed)
    return dense.program_config(m, cell)


def leaves(m):
    return [leaf for leaf in dense.leaves(m) if leaf[0] != ("lm_head",)]


def forward(params, tokens, m, *, fixed=None, quant=None, remat=False):
    _handed(fixed)
    x = dense.trunk(params, tokens, m, quant=quant, remat=remat)
    return mm("...e,ve->...v", x, params["embed"]["tokens"].float(), quant)
'''

# A reader of one span and one counter of the program.
READER = '''"""forward_host_ms.train: host ms of the span lm::forward in the traced
steps, over the steps that the program's counter bench_test_steps counted."""


def read(ctx):
    spans = [r for r in ctx["spans"]["traced"] if r["name"] == "lm::forward"]
    steps = ctx["counters"].get("bench_test_steps")
    if not spans or not steps:
        return None
    return 1e3 * sum(r["end"] - r["start"] for r in spans) / steps
'''
NEW_CELL = "tied-model.train-1k"


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """A copy of the benchmark that gains a family, a configuration of it
    cut in depth, a cell with its own traffic file, and a per-layer metric
    with its reader: files and entries only. Yields the copy's root, the
    digests of the files it had before, and the configuration's entry."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    before = _digest(root / "benchmark")
    (root / "benchmark" / "families" / "tied.py").write_text(TIED)
    m = dict(manifest.config("internlm2-1.8b"), name="tied-model", family="tied",
             tie_word_embeddings=True, num_hidden_layers=12,
             published={"num_hidden_layers": 24},
             deployment={"chips": 2, "how": "pipeline: the other 12 layers on a second card"})
    (root / "benchmark" / "configs" / "tied-model.json").write_text(json.dumps(m))
    (root / "benchmark" / "workloads" / f"{NEW_CELL}.json").write_text(
        json.dumps(dict(json.loads((manifest.BENCH_DIR / "workloads"
                                    / "internlm2-1.8b.train-4k.json").read_text()),
                        traffic={"batch": 16, "seq": 1024})))
    (root / "benchmark" / "metrics" / "forward_host_ms.train.py").write_text(READER)
    entry = {"name": "tied-model", "source": "https://example.org/tied",
             "file": "benchmark/configs/tied-model.json", "reduced": ["num_hidden_layers"],
             "why": "x"}
    bench["configs"].append(entry)
    bench["workloads"].append({"name": NEW_CELL, "config": "tied-model",
                               "traffic": "train-1k", "chips": 1, "why": "x"})
    tokens = next(m for m in bench["end_to_end"] if m["name"] == "train_tokens_per_s")
    tokens["workloads"].append(NEW_CELL)
    bench["per_layer"].append({"name": "forward_host_ms.train", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "model step (models/lm.py)",
                               "moves": "train_tokens_per_s", "workloads": [NEW_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(manifest, "ROOT", root)
    monkeypatch.setattr(manifest, "BENCH_DIR", root / "benchmark")
    yield root, before, entry
    assert {k: v for k, v in _digest(root / "benchmark").items() if k in before} == before


def test_a_new_cell_needs_no_edit(checkout):
    """The harness finds all of the copy's new files, and the cut has the
    form a cut must have."""
    root, _, entry = checkout
    cell = manifest.workload(NEW_CELL, manifest.manifest())
    m = manifest.config(cell["config"])
    assert m["name"] == "tied-model" and cut_faults(entry["reduced"], m) == []
    assert manifest.family(m).__name__ == "benchmark.families.tied"
    assert [p for p, _, _ in manifest.family(m).leaves(m)][-1] == ("final_norm",)
    assert cell["traffic"] == {"batch": 16, "seq": 1024}
    assert [m["name"] for m in manifest.end_to_end(manifest.manifest(), cell["name"])] == [
        "train_tokens_per_s", "setup_s"]
    names = [m["name"] for m in manifest.per_layer(manifest.manifest(), cell["name"])]
    assert names == ["forward_host_ms.train"]
    assert manifest.reader("forward_host_ms.train").read(
        {"spans": {"traced": []}, "counters": {}}) is None


def test_the_new_cell_runs_and_its_reader_finds_its_number(checkout, monkeypatch):
    """The copy's cell through kinds/train.run at its tiny size on the CPU,
    traced, with the program counting its steps: the reader of a span and a
    counter finds its number in the result line, and the run is correct."""
    from ray_tpu_torch.models import lm
    from ray_tpu_torch.util import metrics

    counted = metrics.Counter("bench_test_steps")
    real = lm.LMTrainContext.train_step

    def counting(self, state, batch):
        counted.inc()
        return real(self, state, batch)

    monkeypatch.setattr(lm.LMTrainContext, "train_step", counting)
    out = manifest.kind("train").run(tiny.cell(NEW_CELL), tiny.model("tied-model"), 2**31 + 61,
                                     0.2, True, time.perf_counter(), device="cpu")
    assert out["context"]["counters"]["bench_test_steps"] == 2
    assert ("lm_head",) not in out["readings"]["reference"]["first_grad"]
    result = run.report(manifest.manifest(), NEW_CELL, out, True)
    assert result["metrics"]["forward_host_ms.train"]["value"] > 0
    assert result["correct"], result["checks"]
