"""A run with the timed path broken underneath comes out not correct, with
the cells' own limits: on the CPU at a tiny size, the harness's look for a
card skipped and the rest of a run driven as the chip runs it.

Faults: a training step that leaves its state unchanged; half of each batch
left out, the mean taken over the rest. (One chip: no exchange between
chips to leave out; no answers to alter.) A sound run is correct."""

import time

import pytest

from benchmark import manifest, run, tiny

BENCH = manifest.manifest()
TRAIN = "internlm2-1.8b.train-4k"


def _train(seed):
    cell = tiny.cell(TRAIN)
    out = manifest.kind("train").run(cell, tiny.model(), seed, 0.5, False,
                                     time.perf_counter(), device="cpu")
    return run.report(BENCH, TRAIN, out, False)


def test_a_sound_training_run_is_correct():
    assert _train(2**31 + 21)["correct"]


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from ray_tpu_torch.models import lm

    real = lm.default_optimizer

    def frozen(*a, **kw):
        opt = real(*a, **kw)
        return lm.Optimizer(opt.init, lambda grads, state, params, grad_norm=None: state)

    monkeypatch.setattr(lm, "default_optimizer", frozen)
    result = _train(2**31 + 22)
    assert not result["correct"]
    assert result["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_fails(monkeypatch):
    from ray_tpu_torch.models import lm

    real = lm.LMTrainContext.make_batch

    def half(self, batch):
        return {k: v[: v.shape[0] // 2] for k, v in real(self, batch).items()}

    monkeypatch.setattr(lm.LMTrainContext, "make_batch", half)
    assert not _train(2**31 + 23)["correct"]
