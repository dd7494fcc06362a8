"""``chip_smoke.py``'s ``serve_multiplex_redeploy`` phase rehearsed on the
CPU through the same drive, ``ray_tpu_torch/tools/multiplex_runs.py``, at
``GPT2Config.small_test`` size: a multiplexed GPT-2 deployment whose class
reaches its replica only through a ``runtime_env`` working_dir serves
phase 6's five requests to model ids 0, 1, 0, 2, 1 (4 loads, the last a
reload of 1; models 1 and 2 resident after), each answer equal to the
tokens of a model of that seed run in this process; then a second
working_dir, whose module tags its answers ``v2``, is deployed under the
same app name and route while a client sends requests without pause: every
answer is 200, and the tags switch from ``v1`` to ``v2`` once.

The cluster advertises one GPU, and each version's replica leases half of
it as on the card, where a rolling update keeps the old replica serving
until the new one is up. On CPU tensors the attention wrapper runs its
plain version, so no kernel is launched here.
"""

import copy

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.tools import multiplex_runs as mx

MODEL = dict(attention="flash", dtype=torch.float32)
CFG = gpt2.GPT2Config.small_test(**MODEL)
MAX_TOKENS = 4


@pytest.fixture(scope="module")
def card_cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    serve.start()
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _prompts():
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, CFG.vocab_size, size=n).tolist()
               for n in (8, 13, 20, 30)]
    return prompts + [prompts[0]]


@pytest.fixture(scope="module")
def drive(card_cluster, tmp_path_factory):
    prompts = _prompts()
    expected = mx.reference_tokens(MODEL, "cpu", prompts, mx.IDS, MAX_TOKENS)
    rollout_expected = mx.reference_tokens(
        MODEL, "cpu", [prompts[0]], [mx.ROLLOUT_ID], mx.ROLLOUT_TOKENS)[0]
    out = mx.drive(str(tmp_path_factory.mktemp("multiplex")),
                   serve.http_port(), prompts, MODEL, max_tokens=MAX_TOKENS,
                   device="cpu")
    serve.delete(mx.APP)
    return out, expected, rollout_expected


def test_shipped_multiplexed_deployment_redeploys_with_no_failed_request(
        drive):
    out, expected, rollout_expected = drive
    assert mx.problems(out, expected, rollout_expected, CFG.n_layer,
                       on_card=False) == []
    assert out["v1"]["loads"] == ["0", "1", "2", "1"]
    assert out["rollout_requests"] > 0
    assert out["serve_run_to_first_v2_s"] is not None
    # prompt 0 went to models 0 and 1: two seeds, two models
    assert expected[0] != expected[4]


def _planted(out, fault):
    out = copy.deepcopy(out)
    if fault == "tokens":
        out["answers"][2]["body"]["tokens"][0] += 1
    elif fault == "loads":
        out["v1"]["loads"] = ["0", "1", "2"]
    elif fault == "resident":
        out["v1"]["resident"] = ["0", "1", "2"]
    elif fault == "status":
        out["rollout"][-1]["status"] = 503
    elif fault == "back":
        out["rollout"].append(dict(out["rollout"][0]))
    elif fault == "imported":
        out["module_in_this_process"] = True
    elif fault == "launches":
        out["v1"]["launches"]["flash_fwd"] += 1
    return out


@pytest.mark.parametrize("fault", ["tokens", "loads", "resident", "status",
                                   "back", "imported", "launches"])
def test_the_checks_see_each_planted_fault(drive, fault):
    out, expected, rollout_expected = drive
    found = mx.problems(_planted(out, fault), expected, rollout_expected,
                        CFG.n_layer, on_card=False)
    assert len(found) == 1, found
