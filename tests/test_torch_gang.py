"""``chip_smoke.py`` phase 36's path on the CPU, at ``small_test`` size:
the object plane's two forms of a model's parameters read by three
readers, and GPT-2 trained by two ranks whose gradients are mean-reduced
by ``train.GradSync`` over the store collective (``tools/gang_runs.py``).

The two ranks' f32 losses equal one process's on the whole batch
(``build_train_step`` from the same seeded weights) to 1e-5; that step is
held against the JAX package by ``tests/test_torch_train.py``. Rank 0's
reduced first gradient equals the whole batch's, per parameter, to
``GRAD_LIMIT`` (and the mean of the ranks' own gradients taken in one
process to ``GANG["halves_limit"]``), and the same check fails on what a
reduction that sums, or none, would have handed rank 0 (AdamW's step
hardly depends on the gradient's scale, so the losses alone would not show
a sum). The int8
fit's first reduced gradient lies within the reference's analytic bound of
the f32 one, per parameter. A small ``collective_chunk_bytes`` makes the
small model's gradients chunk, as GPT-2-124M's larger ones do at the
default on the card.
"""

import json
import os

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.tools import gang_runs

import chip_smoke
from tests.torch_fixtures import port_regular  # noqa: F401

ROWS, SEQ = 2, 32
# f32 on the CPU: the largest gap measured was 2.0e-7 (h.0.attn.c_attn.weight;
# a sum gives 1.0 and no reduction 0.72-1.26)
GRAD_LIMIT = 1e-5


def _one_process_losses(steps):
    cfg = gang_runs._config("small_test")
    model, opt = gpt2.make_train_state(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
    step = gpt2.build_train_step(model, opt)
    batch = gpt2.synthetic_batch(1, 2 * ROWS, SEQ, cfg.vocab_size,
                                 device="cpu")
    return [float(step(model, opt, batch)[2]) for _ in range(steps)]


def test_objects_reach_every_reader_and_leave_the_store(port_regular):
    fields, problems = chip_smoke.gang_objects(model="small_test",
                                               device="cpu", card_gpu=0)
    assert problems == [], problems
    assert fields["params"] == gang_runs._config("small_test").num_params()
    for name, read in fields["reads"].items():
        assert read["tensor_devices"] == ["cpu"], name
    assert not fields["torch_pickle_in_hidden_reader"]["raised"]
    assert len(fields["summary_rows"]) == 2
    json.dumps(fields)


@pytest.fixture(scope="module")
def gang(port_regular, tmp_path_factory):
    root = tmp_path_factory.mktemp("gang")
    fits, bound, gaps = chip_smoke.gang_gradsync(
        str(root), model="small_test", device="cpu", seq=SEQ,
        resources={"CPU": 1}, use_gpu=False, chunk_bytes=4096, rows=ROWS)
    return root, fits, bound, gaps


def test_gradsync_gang_trains_like_one_process(gang):
    root, fits, bound, gaps = gang
    want = _one_process_losses(chip_smoke.GANG["steps"]["f32"])
    fields, problems = chip_smoke._gang_problems(fits, bound, gaps,
                                                 GRAD_LIMIT, want, 0, "cpu")
    assert problems == [], problems
    f32, int8 = fields["f32"], fields["int8"]
    assert max(abs(a - b) for a, b in zip(f32["losses"], want)) <= 1e-5
    assert f32["chunks"] > 0 and int8["chunks"] > 0
    assert f32["wire_bytes"] == f32["logical_bytes"]
    assert int8["wire_bytes"] < 0.5 * int8["logical_bytes"]
    assert fields["int8_vs_f32_step1"]["worst_err_over_bound"] <= 1.0
    assert len(int8["losses"]) == chip_smoke.GANG["steps"]["int8"]
    assert fields["reduced_vs_whole_step1"]["worst_mean"]["rel_err"] \
        <= GRAD_LIMIT
    trace = ray_tpu_torch.util.state.train_timeline(
        os.path.join(root, "timeline.json"))
    assert {"rank 0", "rank 1"} <= {e["args"]["name"] for e in trace
                                    if e["ph"] == "M"}


@pytest.mark.parametrize("fault", ["sum", "rank0"])
def test_gradient_check_fails_on_a_wrong_reduction(gang, fault):
    """The reduced gradient that a SUM (twice the mean) or no reduction at
    all (rank 0's own) would have left rank 0 fails the check."""
    _, fits, bound, gaps = gang
    want = _one_process_losses(chip_smoke.GANG["steps"]["f32"])
    planted = dict(gaps, mean=gaps[fault])
    _, problems = chip_smoke._gang_problems(fits, bound, planted, GRAD_LIMIT,
                                            want, 0, "cpu")
    assert any("reduced step-1 gradient" in p for p in problems), problems
    worst = max(gaps[fault].values())
    assert worst > 100 * GRAD_LIMIT, worst
