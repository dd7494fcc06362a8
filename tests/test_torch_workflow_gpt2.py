"""The slice as a whole on the CPU: ``tools/workflow_runs.drive``, the path
of ``chip_smoke.py`` phase 35, at a small GPT-2 (2 layers, width 64,
sequence 64), held against the JAX package.

The durable train-then-serve workflow runs with its first driver killed
while the event step waits, and resumes from this process; the queue run
feeds a consumer actor through a bounded queue. The train step starts from
the JAX package's initial weights (carried across by
``convert.params_from_jax``), so its losses are held against the JAX
train step's on the same batch at ``tests/test_torch_train.py``'s loss
tolerance (atol = rtol = 1e-5, f32 sums in another order). The served
tokens must equal the JAX package's greedy decode of the saved weights,
and the queue consumer's those of the JAX decode of the port's seed-0
serving weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.tools import workflow_runs

SMALL = dict(vocab_size=512, n_positions=128, n_embd=64, n_layer=2,
             n_head=4)
CONFIG = {
    "device": "cpu", "num_gpus": 0.5, "steps": 4, "batch": 2, "seq": 64,
    "train_model": {"preset": "small_test", "attention": "flash",
                    "loss_chunks": 4, "dtype": "float32"},
    "serve_model": dict(SMALL, attention="flash", dtype="float32"),
    "prompt_lens": [8, 13, 30, 50], "new_tokens": 16,
}


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


def _jax_greedy(model, params, tokens, n):
    """Greedy tokens of the JAX model: one jitted forward at the full
    length, right-padded (causal, so a position never sees the padding),
    read at the last real position."""
    forward = jax.jit(lambda p, ids: model.apply({"params": p}, ids))
    width = SMALL["n_positions"]
    seq, out = list(tokens), []
    for _ in range(n):
        ids = np.zeros((1, width), np.int32)
        ids[0, :len(seq)] = seq
        logits = forward(params, jnp.asarray(ids))
        out.append(int(jnp.argmax(logits[0, len(seq) - 1])))
        seq.append(out[-1])
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX side's starting weights, then the drive from them."""
    workdir = tmp_path_factory.mktemp("workflow_gpt2")
    jcfg = jgpt2.GPT2Config.small_test(dtype=jnp.float32, attention="flash",
                                       loss_chunks=4)
    jmodel, jparams = jgpt2.init_params(jcfg, jax.random.PRNGKey(0))
    init = workdir / "init.pt"
    torch.save(params_from_jax(jax.tree.map(np.asarray, jparams)), init)
    config = dict(CONFIG, init=str(init))
    out = workflow_runs.drive(str(workdir), config,
                              dict(num_cpus=4, num_gpus=1))
    return config, out, jcfg, jmodel, jparams


def test_the_killed_workflow_resumes_without_rerunning_its_train_step(run):
    config, out, *_ = run
    assert workflow_runs.problems(out, config, SMALL["n_layer"]) == []
    assert out["status_after_kill"] == "RESUMABLE"
    assert out["calls"].count("train_step") == 1
    assert out["queue"]["blocked_put_s"] and \
        len(out["queue"]["round_trip_s"]) == len(config["prompt_lens"])


def test_train_step_losses_equal_the_jax_train_step(run):
    config, out, jcfg, jmodel, jparams = run
    batch = tgpt2.synthetic_batch(1, config["batch"], config["seq"],
                                  jcfg.vocab_size, device="cpu")
    jbatch = {k: jnp.asarray(v.numpy().astype(np.int32))
              for k, v in batch.items()}
    tx = jgpt2.make_optimizer()
    step = jgpt2.build_train_step(jmodel, tx, donate=False)
    opt_state, want = tx.init(jparams), []
    for _ in range(config["steps"]):
        jparams, opt_state, loss = step(jparams, opt_state, jbatch)
        want.append(float(loss))
    np.testing.assert_allclose(out["train"]["losses"], want, atol=1e-5,
                               rtol=1e-5)


def test_served_tokens_equal_the_jax_greedy_decode(run):
    config, out, jcfg, _, jparams = run
    sd = torch.load(out["train"]["weights"])
    tree = _to_jax(sd, jax.tree.map(np.asarray, jparams))
    # the inverse is exact: the tree crosses back to the same state dict
    back = params_from_jax(jax.tree.map(np.asarray, tree))
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    dmodel = jgpt2.GPT2(jgpt2.GPT2Config.small_test(dtype=jnp.float32,
                                                    attention="flash"))
    lens = config["prompt_lens"]
    want = [_jax_greedy(dmodel, tree, workflow_runs.prompt(i, lens, 512),
                        config["new_tokens"]) for i in range(len(lens))]
    assert out["serve"]["tokens"] == want
    assert out["output"]["tokens"] == want


def test_queue_consumer_tokens_equal_the_jax_greedy_decode(run):
    config, out, *_ = run
    lens = config["prompt_lens"]
    q = out["queue"]
    assert q["prompts"] == [workflow_runs.prompt(i, lens, 512)
                            for i in range(len(lens))]
    serving = tgpt2.init_params(tgpt2.GPT2Config.small_test(**SMALL),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    jtree = _to_jax(serving.state_dict(), jax.tree.map(
        np.asarray, jgpt2.init_params(jgpt2.GPT2Config.small_test(
            dtype=jnp.float32), jax.random.PRNGKey(0))[1]))
    dmodel = jgpt2.GPT2(jgpt2.GPT2Config.small_test(dtype=jnp.float32,
                                                    attention="flash"))
    want = [_jax_greedy(dmodel, jtree, p, config["new_tokens"])
            for p in q["prompts"]]
    assert q["tokens"] == want
