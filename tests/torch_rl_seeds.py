"""RL learning outcomes of both packages across seeds, on the CPU.

``expert`` runs what the ``expert_dataset`` fixtures of
``tests/test_rllib_extra_algos.py`` and ``tests/test_torch_rllib_offline.py``
run: one CartPole runner (seed ``seed``), 8 PPO iterations of one 512-step
fragment each (6 epochs, minibatches of 128), then the recording, two more
512-step fragments sampled with the weights of the last sync (the fixtures
record without syncing after the 8th update). It builds the package's own
``EnvRunner`` and ``PPOLearner`` here instead of actors, which changes no
number: the fixture's seed-0 recordings end 12 (JAX package) and 20 (port)
episodes, here as there.

``shared_draws=True`` takes every exploration action of both packages from
one numpy stream (``u < p(action 0)``) and starts the port from the JAX
package's initial weights, so that the two runs differ only by the rounding
of their float arithmetic.

``drift`` feeds the JAX package's runner's fragments to three learners
from the same starting weights: the JAX package's, the port's running free,
and the port's set to the JAX learner's weights and Adam moments before
each Adam step. Per step it gives the single step's and the free run's
largest weight difference, and the minibatch samples whose PPO ratio one
package clips and the other does not.

``dreamerv3_best`` runs the learning case of ``tests/test_rllib_dreamerv3.py``
and ``tests/test_torch_rllib_dreamerv3.py`` at a seed: the best episode
return in 35 iterations.

Run as a script it prints one JSON line per (package, seed) and then both
samples' medians with a Mann-Whitney U and a two-sample Kolmogorov-Smirnov
test: of the PPO recordings' episode ends, or with ``--dreamerv3`` of
DreamerV3's best returns; ``--drift SEED`` prints ``drift``'s steps:

    JAX_PLATFORMS=cpu python tests/torch_rl_seeds.py --seeds 0-59 --jobs 6
    JAX_PLATFORMS=cpu python tests/torch_rl_seeds.py --drift 0
    JAX_PLATFORMS=cpu python tests/torch_rl_seeds.py --dreamerv3 --seeds 0-4
"""

import argparse
import concurrent.futures as cf
import contextlib
import json
import multiprocessing as mp
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
ITERATIONS = 8
FRAGMENT = 512
MODEL = {"hiddens": (64, 64), "dueling": False}


def _package(pkg):
    if pkg == "ref":
        from ray_tpu.rllib import algorithm, env_runner, learner, rl_module
        from ray_tpu.rllib import sample_batch
    else:
        import torch

        torch.set_num_threads(1)
        from ray_tpu_torch.rllib import algorithm, env_runner, learner
        from ray_tpu_torch.rllib import rl_module, sample_batch
    return algorithm, env_runner, learner, rl_module, sample_batch


@contextlib.contextmanager
def _shared_draws(pkg, rl_module, env_runner, seed):
    """Both packages' exploration draws from ``default_rng(10_000 + seed)``;
    the JAX runner's value of a state is read without a draw, as the
    port's is."""
    rng = np.random.default_rng(10_000 + seed)

    def forward(module, obs):
        if pkg == "ref":
            logits, value = module.forward(module.params, obs)
        else:
            logits, value = module.forward(obs)
        return np.asarray(logits, np.float64), np.asarray(value, np.float32)

    def action_exploration(self, obs, _key):
        logits, value = forward(self, obs)
        logp = logits - logits.max(-1, keepdims=True)
        logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
        a = 0 if rng.uniform() < np.exp(logp[0, 0]) else 1
        return np.array([a]), np.array([logp[0, a]], np.float32), value

    def value_of(self, obs_f):
        return float(forward(self.module,
                             np.asarray(obs_f, np.float32)[None, :])[1][0])

    saved = (rl_module.RLModule.action_exploration,
             env_runner.EnvRunner._value_of)
    rl_module.RLModule.action_exploration = action_exploration
    env_runner.EnvRunner._value_of = value_of
    try:
        yield
    finally:
        (rl_module.RLModule.action_exploration,
         env_runner.EnvRunner._value_of) = saved


def expert(pkg, seed, shared_draws=False, iterations=ITERATIONS):
    """{"ends": episode ends in the recording, "iter_dones": terminations
    in each training fragment, "actions": each training fragment's
    actions}."""
    algorithm, env_runner, learner, rl_module, sample_batch = _package(pkg)
    cfg = algorithm.PPOConfig().environment("CartPole-native").env_runners(
        num_env_runners=1, rollout_fragment_length=FRAGMENT).training(
        num_epochs=6, minibatch_size=128).debugging(seed=seed)
    draws = (_shared_draws(pkg, rl_module, env_runner, seed) if shared_draws
             else contextlib.nullcontext())
    with draws:
        kw = {} if pkg == "ref" else {"device": "cpu"}
        module = rl_module.RLModule((4,), 2, seed=seed, **kw)
        if pkg == "port" and shared_draws:
            import jax

            from ray_tpu.rllib.rl_module import RLModule
            from ray_tpu_torch.models import convert

            module.set_state(convert.rl_module_params_from_jax(
                jax.tree.map(np.asarray, RLModule((4,), 2, seed=seed).params)))
        ppo = learner.PPOLearner(module, cfg)
        runner = env_runner.EnvRunner("CartPole-native", None, dict(MODEL),
                                      seed=seed)
        iter_dones, actions = [], []
        for _ in range(iterations):
            runner.set_weights(ppo.get_weights())
            frag = runner.sample(FRAGMENT)
            iter_dones.append(int(np.sum(frag["dones"])))
            actions.append(np.asarray(frag["actions"]).tolist())
            ppo.update(sample_batch.compute_gae(
                frag, float(frag["bootstrap_value"][-1]), cfg.gamma,
                cfg.lambda_))
        recorded = [runner.sample(FRAGMENT) for _ in range(2)]
    ends = int(sum(np.sum(r["dones"]) + np.sum(r["truncateds"])
                   for r in recorded))
    return {"ends": ends, "iter_dones": iter_dones, "actions": actions}


def _max_diff(port_state, jax_params):
    from ray_tpu_torch.models import convert

    want = convert.rl_module_params_from_jax(jax_params)
    return max(float(np.abs(np.asarray(port_state[k]) -
                            np.asarray(want[k])).max()) for k in want)


def _clipped(logp_all, mb, clip):
    """Samples whose surrogate the clip cuts off (zero gradient)."""
    acts = np.asarray(mb["actions"])
    ratio = np.exp(np.asarray(logp_all)[np.arange(len(acts)), acts] -
                   np.asarray(mb["logp"]))
    adv = np.asarray(mb["advantages"])
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    return (((ratio > 1 + clip) & (adv > 0)) |
            ((ratio < 1 - clip) & (adv < 0))), ratio


def drift(seed, updates=5):
    """[{"update", "epoch", "minibatch", "step_diff", "free_diff", "flips":
    [[sample, JAX ratio, port ratio], ...]}] for every Adam step of
    ``updates`` PPO updates (see the module's docstring)."""
    import jax
    import jax.numpy as jnp
    import torch

    from ray_tpu_torch.models import convert

    ja, je, jlearn, jmod, jsb = _package("ref")
    ta, _, tlearn, tmod, _ = _package("port")
    cfg = ja.PPOConfig().training(num_epochs=6, minibatch_size=128)
    tcfg = ta.PPOConfig().training(num_epochs=6, minibatch_size=128)
    jm = jmod.RLModule((4,), 2, seed=seed)
    flat = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    ports = []
    for _ in range(2):
        tm = tmod.RLModule((4,), 2, seed=seed, device="cpu")
        tm.set_state(convert.rl_module_params_from_jax(flat(jm.params)))
        ports.append(tlearn.PPOLearner(tm, tcfg))
    free, synced = ports
    jl = jlearn.PPOLearner(jm, cfg)
    runner = je.EnvRunner("CartPole-native", None, dict(MODEL), seed=seed)
    rng, rows = np.random.default_rng(0), []
    for update in range(updates):
        runner.set_weights(jl.get_weights())
        frag = runner.sample(FRAGMENT)
        batch = jsb.compute_gae(frag, float(frag["bootstrap_value"][-1]),
                                cfg.gamma, cfg.lambda_)
        for epoch in range(cfg.num_epochs):
            for k, mb in enumerate(batch.shuffled(rng).minibatches(
                    cfg.minibatch_size)):
                adam = jl.opt_state[1][0]
                mu, nu = (convert.rl_module_params_from_jax(flat(t))
                          for t in (adam.mu, adam.nu))
                synced.module.set_state(
                    convert.rl_module_params_from_jax(flat(jm.params)))
                for n, p in synced.module.net.named_parameters():
                    synced.optimizer.state[p] = {
                        "step": torch.tensor(float(adam.count)),
                        "exp_avg": torch.as_tensor(np.asarray(mu[n])),
                        "exp_avg_sq": torch.as_tensor(np.asarray(nu[n]))}
                jmb = {c: jnp.asarray(v) for c, v in mb.items()}
                jcut, jratio = _clipped(jax.nn.log_softmax(jm.net.apply(
                    {"params": jm.params}, jmb["obs"])[0]), mb,
                    cfg.clip_param)
                with torch.no_grad():
                    tcut, tratio = _clipped(torch.log_softmax(
                        free.module.net(torch.as_tensor(mb["obs"]))[0],
                        -1).numpy(), mb, cfg.clip_param)
                jm.params, jl.opt_state, _ = jl._train_step(
                    jm.params, jl.opt_state, jmb)
                for learner in ports:
                    learner._train_step(learner._tensors(mb))
                rows.append({
                    "update": update, "epoch": epoch, "minibatch": k,
                    "step_diff": _max_diff(synced.module.get_state(),
                                           flat(jm.params)),
                    "free_diff": _max_diff(free.module.get_state(),
                                           flat(jm.params)),
                    "flips": [[int(i), float(jratio[i]), float(tratio[i])]
                              for i in np.nonzero(jcut != tcut)[0]]})
    return rows


def dreamerv3_best(pkg, seed):
    """The best ``episode_return_mean`` of 35 DreamerV3 iterations on
    CartPole at ``seed``, the learner on the CPU."""
    if pkg == "ref":
        from ray_tpu.rllib import DreamerV3Config

        cfg = DreamerV3Config()
    else:
        import torch

        torch.set_num_threads(1)
        from ray_tpu_torch.rllib import DreamerV3Config

        cfg = DreamerV3Config().learners(num_gpus_per_learner=0)
    algo = cfg.environment("CartPole-native").debugging(seed=seed).build()
    best = 0.0
    try:
        for _ in range(35):
            r = algo.train().get("episode_return_mean")
            if r is not None:
                best = max(best, r)
    finally:
        algo.stop()
    return best


def _run(pkg, seeds, mode):
    sys.path.insert(0, str(REPO))
    out = []
    for seed in seeds:
        if mode == "dreamerv3":
            out.append({"pkg": pkg, "seed": seed,
                        "best": dreamerv3_best(pkg, seed)})
            continue
        got = expert(pkg, seed, mode == "shared")
        got.pop("actions")
        out.append(dict(pkg=pkg, seed=seed, **got))
    return out


def _seeds(text):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default="0-9", help="e.g. 0-59")
    p.add_argument("--jobs", type=int, default=2)
    p.add_argument("--shared-draws", action="store_true")
    p.add_argument("--dreamerv3", action="store_true")
    p.add_argument("--drift", type=int, metavar="SEED")
    args = p.parse_args()
    if args.drift is not None:
        sys.path.insert(0, str(REPO))
        for row in drift(args.drift):
            print(json.dumps(row))
        return
    seeds = _seeds(args.seeds)
    per = -(-len(seeds) * 2 // args.jobs)
    chunks = [(pkg, seeds[i:i + per]) for pkg in ("ref", "port")
              for i in range(0, len(seeds), per)]
    mode = ("dreamerv3" if args.dreamerv3 else
            "shared" if args.shared_draws else "own")
    key = "best" if args.dreamerv3 else "ends"
    rows = []
    with cf.ProcessPoolExecutor(args.jobs,
                                mp_context=mp.get_context("spawn")) as ex:
        for got in ex.map(_run, *zip(*chunks), [mode] * len(chunks)):
            for row in got:
                print(json.dumps(row), flush=True)
            rows += got
    from scipy import stats

    got = {pkg: np.array([r[key] for r in sorted(
        rows, key=lambda r: r["seed"]) if r["pkg"] == pkg])
        for pkg in ("ref", "port")}
    print(json.dumps({
        "seeds": args.seeds, "mode": mode,
        **{f"{pkg}_median": float(np.median(v)) for pkg, v in got.items()},
        **{f"{pkg}_mean": float(np.mean(v)) for pkg, v in got.items()},
        **{f"{pkg}_{key}": v.tolist() for pkg, v in got.items()},
        "mann_whitney_p": float(stats.mannwhitneyu(got["ref"],
                                                   got["port"]).pvalue),
        "ks_p": float(stats.ks_2samp(got["ref"], got["port"]).pvalue)}))


if __name__ == "__main__":
    main()
