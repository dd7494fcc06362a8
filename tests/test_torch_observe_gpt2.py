"""``chip_smoke.py``'s ``observe_dag_actor`` phase rehearsed on the CPU
through the same drive, ``ray_tpu_torch/tools/observe_runs.py``, at
``GPT2Config.small_test`` size: a GPT-2 actor (seed 0, f32) decodes four
prompts through ``experimental_compile(actor.generate.bind(InputNode()))``
while the cluster's CPU and memory profilers sample, then is scraped
through the dashboard's ``/metrics``, traced under a driver span, listed by
the dashboard and read back through the log plane by its id. Every check
of ``observe_runs.problems`` runs here, and each sees its fault planted.

The actor leases no GPU (``num_gpus=0``); the cluster advertises one, so
``ray_tpu_resources_total`` shows GPU 1 as on the card. On CPU tensors the
attention wrapper runs its plain version, so no kernel is launched.

The compiled DAG's greedy tokens are held against the JAX package's GPT-2
on the same weights (the port's seed-0 state dict carried across by the
inverse of ``convert.params_from_jax``): one forward of each prompt and
its answer, teacher-forced, must pick the answer's tokens, its logits at
those positions within atol = rtol = 2e-4 of the port's
(``tests/test_torch_gpt2.py``'s logit tolerance: f32 sums in another
order).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ray_tpu_torch
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.serve.llm.model import GPT2LLM
from ray_tpu_torch.tools import observe_runs as ob

MODEL = dict(attention="flash", dtype=torch.float32)
CFG = gpt2.GPT2Config.small_test(**MODEL)
MAX_TOKENS = ob.MAX_TOKENS
LOGIT_TOL = 2e-4


@pytest.fixture(scope="module")
def observed():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, CFG.vocab_size, size=n).tolist()
               for n in (8, 13, 20, 30)]
    try:
        out = ob.drive(prompts, MODEL, device="cpu", num_gpus=0)
    finally:
        ray_tpu_torch.shutdown()
    return prompts, out


def _to_jax(sd, template, prefix=()):
    """The inverse of ``params_from_jax``: a Flax tree shaped like
    ``template`` from the port's state dict."""
    out = {}
    for key, node in template.items():
        if isinstance(node, dict):
            out[key] = _to_jax(sd, node, prefix + (key.replace("_", ".")
                                                   if key.startswith("h_")
                                                   else key,))
            continue
        name = ".".join(prefix + ("bias" if key == "bias" else "weight",))
        x = sd[name].detach().numpy()
        out[key] = jnp.asarray(x.T if key == "kernel" else x)
    return out


@pytest.fixture(scope="module")
def reference():
    """The port's seed-0 model (the actor's weights) and the JAX model on
    the same weights; the bridge is checked to cross back exactly."""
    port = GPT2LLM(device="cpu", seed=0, **MODEL)
    sd = port.model.state_dict()
    jcfg = jgpt2.GPT2Config.small_test(dtype=jnp.float32, attention="flash")
    jmodel, jparams = jgpt2.init_params(jcfg, jax.random.PRNGKey(0))
    tree = _to_jax(sd, jax.tree.map(np.asarray, jparams))
    back = params_from_jax(jax.tree.map(np.asarray, tree))
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    return port, jmodel, tree


def test_observed_gpt2_actor_passes_every_check(observed, reference):
    prompts, out = observed
    port = reference[0]
    expected = []
    for p in prompts:
        tokens, got = list(p), []
        for _ in range(MAX_TOKENS):
            got.append(port.forward_next(tokens))
            tokens.append(got[-1])
        expected.append(got)
    assert ob.problems(out, expected, CFG.n_layer) == []
    assert out["probe"]["forwards"] == len(prompts) * MAX_TOKENS
    assert out["profile"]["attention_stacks"] > 0
    assert set(out["round_trip_s"]) == {"compiled_dag", "dag_execute",
                                        "direct"}
    assert out["tokens_per_s"]["no_sampler"] > 0


def test_compiled_dag_tokens_equal_the_jax_gpt2(observed, reference):
    prompts, out = observed
    port, jmodel, tree = reference
    forward = jax.jit(lambda p, ids: jmodel.apply({"params": p}, ids))
    for p, answer in zip(prompts, out["answers"]):
        seq = list(p) + answer[:-1]
        at = slice(len(p) - 1, len(seq))
        want = np.asarray(forward(tree, jnp.asarray([seq], jnp.int32)))[0]
        got = port.logits(seq).numpy()
        assert np.argmax(want[at], axis=-1).tolist() == answer
        np.testing.assert_allclose(got[at], want[at], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def _planted(out, fault):
    out = copy.deepcopy(out)
    if fault == "tokens":
        out["answers"][1][0] += 1
    elif fault == "launches":
        out["probe"]["launches"]["flash_bwd_dq"] += 1
    elif fault == "device":
        out["probe"]["device"] = "cuda:0"
    elif fault == "profile_pid":
        out["profile"]["cpu_pids"].remove(out["probe"]["pid"])
    elif fault == "model_stacks":
        out["profile"]["actor_model_stacks"] = 0
    elif fault == "mem_sites":
        out["profile"]["mem_actor_sites"] = 0
    elif fault == "scrape_tokens":
        out["scrape"]["tokens"] += 1
    elif fault == "scrape_requests":
        out["scrape"]["requests"] -= 1
    elif fault == "gpu_total":
        out["scrape"]["gpu_total"] = 0.0
    elif fault == "actor_log":
        out["actor_log"] = out["actor_log"][:-1]
    elif fault == "task_log":
        out["traced_task_log"].append(out["actor_log"][0])
    elif fault == "parent":
        child = next(s for s in out["spans"]
                     if s["name"].startswith("task::"))
        child["parent_span_id"] = "0" * 16
    elif fault == "timeline":
        out["timeline_spans"] = [ob.DRIVER_SPAN]
    elif fault == "listing":
        out["listing"]["state"] = "DEAD"
    elif fault == "share":
        out["num_gpus"] = 0.5
    return out


FAULTS = ["tokens", "launches", "device", "profile_pid", "model_stacks", "mem_sites",
          "scrape_tokens", "scrape_requests", "gpu_total", "actor_log",
          "task_log", "parent", "timeline", "listing", "share"]


@pytest.mark.parametrize("fault", FAULTS)
def test_the_checks_see_each_planted_fault(observed, fault):
    prompts, out = observed
    found = ob.problems(_planted(out, fault), out["answers"], CFG.n_layer)
    assert len(found) == 1, found
