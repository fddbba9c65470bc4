"""The port's RL algorithm classes (`ray_tpu_torch.rllib`: PPO, IMPALA,
APPO, DQN, SAC, MultiAgentPPO) with their env runners as actors of the
port's runtime, the offline reader and the policy server, on the CPU.

The learner runs in this process (`device="cpu"` here; the card by
default), the runners in actor processes on the CPU. PPO's class is held
bit for bit to the same iterations driven in this process by `EnvRunner`s
and `ppo._make_learner`, the parts tests/test_torch_rllib.py holds to the
JAX package; weights carried over from a JAX tree give JAX's forward. The
tier-1 cases of tests/test_rllib.py follow at their source's thresholds,
and its slow cases are ported as slow, with its reasons.

One port runtime serves the whole file (`ray_tpu_torch.init(num_cpus=4)`);
no `ray_tpu` runtime starts here. Classes and env creators defined in this
file are pickled by reference, so each runner imports this module: it
imports jax and ray_tpu only inside functions.
"""

import os

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.parallel.sharding import tree_leaves
from ray_tpu_torch.rllib import (
    APPOConfig,
    CartPoleVectorEnv,
    DQNConfig,
    EnvRunner,
    IMPALAConfig,
    MultiAgentCartPole,
    MultiAgentPPOConfig,
    PPOConfig,
    SACConfig,
    SampleBatch,
    apply_policy,
)
from ray_tpu_torch.rllib import ppo
from ray_tpu_torch.rllib.policy import to_numpy
from ray_tpu_torch.rllib.rl_module import RLModule
from ray_tpu_torch.util.state import list_actors

# The forward from JAX weights: f32 sums in another order, 1e-6 of the
# output's largest magnitude (tests/test_torch_rllib.py's FWD_TOL).
FWD_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def rt():
    """One port runtime for the file. Torch runs on one thread here and in
    every worker (OMP_NUM_THREADS, which the workers inherit): the
    learners' small products on 8 threads slow down many times over when
    the tier-1 run shares the cores (test_dqn_cartpole_learns: 6.4 s on one
    thread beside 7 busy processes, more than 150 s on 8)."""
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = omp


def _alive(actor_ids) -> list:
    states = {a["actor_id"]: a["state"] for a in list_actors()}
    return [a for a in actor_ids if states.get(a) != "DEAD"]


def _stop_and_check(algo) -> None:
    """stop() kills every runner actor of the algorithm."""
    ids = [r._actor_id for r in algo.runners]
    algo.stop()
    assert algo.runners == []
    import time

    deadline = time.monotonic() + 30
    while _alive(ids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _alive(ids) == []


def _leaf_equal(x, y) -> bool:
    if isinstance(x, torch.Tensor):
        return isinstance(y, torch.Tensor) and torch.equal(x, y)
    if isinstance(x, torch.Generator):
        return isinstance(y, torch.Generator) and torch.equal(x.get_state(), y.get_state())
    return x == y


def _states_equal(a, b) -> bool:
    """Two learner states equal bit for bit: every tensor, every other leaf
    (Adam's count), and each generator's state."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(_leaf_equal(x, y) for x, y in zip(la, lb))


def _trees_equal(a, b) -> bool:
    """Two trees of numpy arrays equal, key by key (a JAX tree's dicts come
    in sorted key order, the port's in its own)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


# -- PPO: the class is the in-process dataflow ------------------------------------------


def _ppo_config():
    return (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_length=16)
            .training(num_epochs=2, minibatch_size=32)
            .debugging(seed=3))


def test_ppo_train_is_the_in_process_dataflow():
    """PPO(cfg, device="cpu") with 2 runner actors, 3 iterations: every
    learner leaf, the metrics, episode_reward_mean and num_env_steps_sampled
    equal, bit for bit, the same 3 iterations driven in this process by
    EnvRunners and the learner of ppo._make_learner with the same seeds."""
    cfg = _ppo_config()
    algo = ppo.PPO(cfg, device="cpu")
    try:
        got = [algo.train() for _ in range(3)]
        state = algo._state
    finally:
        _stop_and_check(algo)

    runners = [EnvRunner(cfg.env, cfg.num_envs_per_runner, cfg.rollout_length, gamma=cfg.gamma,
                         lam=cfg.lam, seed=cfg.seed + 1000 * (i + 1), hidden=cfg.hidden,
                         device="cpu")
               for i in range(cfg.num_env_runners)]
    init_state, update = ppo._make_learner(cfg, 4, 2, device="cpu")
    ref = init_state(cfg.seed)
    returns, steps = [], 0
    for it in range(3):
        results = [r.sample(to_numpy(ref["params"])) for r in runners]
        batch = SampleBatch.concat_samples([SampleBatch(r["batch"]) for r in results])
        returns = (returns + [x for r in results for x in r["episode_returns"]])[-100:]
        steps += sum(r["steps"] for r in results)
        ref, metrics = update(ref, {k: batch[k] for k in ppo.COLUMNS})
        assert returns, "no episode completed"
        want = {"training_iteration": it + 1, "episode_reward_mean": float(np.mean(returns)),
                "num_env_steps_sampled": steps, **{k: float(v) for k, v in metrics.items()}}
        assert {k: got[it][k] for k in want} == want
        assert set(got[it]) == set(want) | {"env_steps_per_sec"}
    assert _states_equal(state, ref)


# -- each algorithm with runner actors ---------------------------------------------------


def _impala():
    return (IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_length=8)
            .training(updates_per_iteration=3).debugging(seed=1))


def _appo():
    return (APPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_length=8)
            .training(updates_per_iteration=3).debugging(seed=1))


def _dqn():
    return (DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_runner=4, rollout_length=8)
            .training(learn_batch_size=32, updates_per_iteration=4).debugging(seed=1))


def _sac():
    return (SACConfig().environment("Pendulum-v1")
            .env_runners(num_env_runners=1, num_envs_per_runner=8, rollout_length=8)
            .training(learning_starts=64, batch_size=32, updates_per_iteration=4,
                      hidden=(32, 32))
            .debugging(seed=0))


def _multi_agent():
    return (MultiAgentPPOConfig()
            .environment(lambda num_envs, seed: MultiAgentCartPole(num_envs, 2, seed))
            .multi_agent({"agent_0": "p0", "agent_1": "p1"})
            .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_length=16)
            .training(num_epochs=2, minibatch_size=32)
            .debugging(seed=5))


_VTRACE_KEYS = {"training_iteration", "episode_reward_mean", "num_env_steps_sampled",
                "env_steps_per_sec", "avg_weights_lag", "num_updates", "num_dead_env_runners",
                "total_loss", "policy_loss", "vf_loss", "entropy"}
# The keys each JAX class's train() reports (ray_tpu/rllib/impala.py:423-432,
# dqn.py:371-380, sac.py:273-279 with the SAC learner's metrics :270-275,
# multi_agent.py:435-442).
RESULT_KEYS = {
    "IMPALA": _VTRACE_KEYS,
    "APPO": _VTRACE_KEYS,
    "DQN": {"training_iteration", "episode_reward_mean", "epsilon", "loss",
            "num_env_steps_sampled", "buffer_size", "time_this_iter_s"},
    "SAC": {"training_iteration", "episode_reward_mean", "num_env_steps_sampled",
            "env_steps_per_sec", "q_loss", "pi_loss", "alpha", "entropy"},
    "MultiAgentPPO": {"training_iteration", "episode_reward_mean", "num_env_steps_sampled",
                      "env_steps_per_sec", "agent_0/episode_reward_mean",
                      "agent_1/episode_reward_mean", "p0/total_loss", "p1/total_loss"},
}
CONFIGS = {"IMPALA": _impala, "APPO": _appo, "DQN": _dqn, "SAC": _sac,
           "MultiAgentPPO": _multi_agent}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_algorithm_trains_with_runner_actors(name):
    """build(device="cpu") starts the runner actors; 2 iterations give
    finite metrics under the JAX class's result keys, and stop() kills the
    runners."""
    algo = CONFIGS[name]().build(device="cpu")
    try:
        assert type(algo).__name__ == name
        assert algo.runners
        results = [algo.train() for _ in range(2)]
    finally:
        _stop_and_check(algo)
    assert [r["training_iteration"] for r in results] == [1, 2]
    assert set(results[-1]) == RESULT_KEYS[name]
    assert all(np.isfinite(v) for v in results[-1].values())
    assert results[-1]["num_env_steps_sampled"] > results[0]["num_env_steps_sampled"] > 0


# -- weights carried over from JAX -------------------------------------------------------


def _jax_policy_tree(seed: int = 0):
    """The JAX package's init_policy_params for CartPole as numpy, the
    policy head scaled up 100-fold so that the argmax of each row below is
    clear of f32 rounding (a fresh head's logits differ by about 1e-3)."""
    import jax

    from ray_tpu.rllib import policy as jax_policy

    tree = jax.tree_util.tree_map(
        np.asarray, jax_policy.init_policy_params(jax.random.PRNGKey(seed), 4, 2, (64, 64)))
    tree["pi"]["w"] = tree["pi"]["w"] * 100.0
    return tree


def _obs(n: int = 32) -> np.ndarray:
    return np.random.default_rng(5).normal(size=(n, 4)).astype(np.float32)


def test_ppo_weights_from_jax():
    """A JAX policy tree through PPO.set_weights comes back from
    get_weights exactly, and the learner's forward on it is JAX's."""
    from ray_tpu.rllib import policy as jax_policy

    tree = _jax_policy_tree()
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_runner=2, rollout_length=4)
            .build(device="cpu"))
    try:
        algo.set_weights(tree)
        got = algo.get_weights()
        assert _trees_equal(got, tree)
        assert all(p.requires_grad for p in tree_leaves(algo._state["params"]))
        logits, values = apply_policy(algo._state["params"], torch.from_numpy(_obs()))
        j_logits, j_values = jax_policy.apply_policy(tree, _obs())
        for ours, theirs in ((logits, j_logits), (values, j_values)):
            theirs = np.asarray(theirs)
            bound = FWD_TOL * max(1.0, float(np.abs(theirs).max()))
            np.testing.assert_allclose(ours.detach().numpy(), theirs, atol=bound, rtol=0)
    finally:
        _stop_and_check(algo)


def test_dqn_greedy_action_is_the_argmax_of_jax_q():
    """DQN.compute_single_action(obs, explore=False) from JAX weights is
    the argmax of JAX's Q (the logits head) on that obs."""
    from ray_tpu.rllib import policy as jax_policy

    tree = _jax_policy_tree(1)
    q = np.asarray(jax_policy.apply_policy(tree, _obs())[0])
    gaps = np.abs(q[:, 0] - q[:, 1])
    assert gaps.min() > 1e-4, gaps.min()
    algo = (DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_runner=2, rollout_length=4)
            .build(device="cpu"))
    try:
        algo.set_weights(tree)
        assert [algo.compute_single_action(o, explore=False) for o in _obs()] == \
            q.argmax(axis=1).tolist()
    finally:
        _stop_and_check(algo)


# -- tier-1 cases of tests/test_rllib.py -----------------------------------------------


def test_ppo_checkpoint_roundtrip(tmp_path):
    """save() after an iteration, restore() into a second PPO: every leaf
    of the learner state (params, Adam's count and moments, the generator)
    and the iteration come back bit for bit, and the next update of each on
    one fixed batch gives equal states and metrics."""
    def config(seed):
        return (PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=1, num_envs_per_runner=4, rollout_length=16)
                .debugging(seed=seed))

    algo, algo2 = config(3).build(device="cpu"), None
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        algo2 = config(4).build(device="cpu")
        assert not _states_equal(algo._state, algo2._state)
        algo2.restore(path)
        assert algo2.iteration == algo.iteration == 1
        assert _states_equal(algo._state, algo2._state)
        runner = EnvRunner("CartPole-v1", 4, 16, seed=9, device="cpu")
        batch = runner.sample(algo.get_weights())["batch"]
        cols = {k: batch[k] for k in ppo.COLUMNS}
        s1, m1 = algo._update(algo._state, cols)
        s2, m2 = algo2._update(algo2._state, cols)
        assert _states_equal(s1, s2)
        assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    finally:
        _stop_and_check(algo)
        if algo2 is not None:
            _stop_and_check(algo2)


def test_dqn_checkpoint_roundtrip(tmp_path):
    """The same for DQN (its target net included): restored bit for bit,
    and the next update_many on one fixed set of batches equal."""
    def config(seed):
        return (DQNConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=1, num_envs_per_runner=4, rollout_length=8)
                .training(learn_batch_size=16, updates_per_iteration=2).debugging(seed=seed))

    algo, algo2 = config(1).build(device="cpu"), None
    try:
        algo.train()
        path = algo.save(str(tmp_path / "dqn"))
        algo2 = config(2).build(device="cpu")
        algo2.restore(path)
        assert algo2.iteration == algo.iteration
        assert _states_equal(algo._state, algo2._state)
        rng = np.random.default_rng(0)
        samples = [algo.buffer.sample(16, rng) for _ in range(3)]
        batches = tuple(np.stack([s[i] for s in samples]) for i in range(5))
        s1, l1 = algo._update(algo._state, batches)
        s2, l2 = algo2._update(algo2._state, batches)
        assert _states_equal(s1, s2) and float(l1) == float(l2)
    finally:
        _stop_and_check(algo)
        if algo2 is not None:
            _stop_and_check(algo2)


class _FlakyCartPole(CartPoleVectorEnv):
    """Raises on the first step() of the process, then behaves."""

    _raised = False

    def step(self, actions):
        if not _FlakyCartPole._raised:
            _FlakyCartPole._raised = True
            raise RuntimeError("transient env failure")
        return super().step(actions)


def test_impala_runner_survives_env_error():
    """A failing trajectory must surface the error but keep the runner in
    the async pipeline (regression: the pool silently shrank to empty)."""
    algo = (
        IMPALAConfig()
        .environment(lambda num_envs, seed: _FlakyCartPole(num_envs, seed))
        .env_runners(num_env_runners=1, num_envs_per_runner=4, rollout_length=8)
        .training(updates_per_iteration=2)
        .debugging(seed=1)
        .build(device="cpu")
    )
    try:
        with pytest.raises(Exception, match="transient env failure"):
            algo.train()
        r = algo.train()  # runner was resubmitted, pipeline intact
        assert r["num_env_steps_sampled"] > 0
    finally:
        _stop_and_check(algo)


def test_dqn_cartpole_learns():
    """Double-DQN with replay + target net clearly learns CartPole
    (reference: rllib dqn suites)."""
    algo = (
        DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_runner=8, rollout_length=32)
        .training(
            lr=1e-3,
            updates_per_iteration=64,
            learn_batch_size=128,
            epsilon_decay_iters=25,
            target_sync_every=2,
        )
        .debugging(seed=3)
        .build(device="cpu")
    )
    try:
        best = 0.0
        for _ in range(80):
            r = algo.train()
            best = max(best, r["episode_reward_mean"])
            if best >= 90.0:
                break
        assert best >= 90.0, f"DQN failed to learn: best={best:.1f}"
        assert r["buffer_size"] > 1000
    finally:
        _stop_and_check(algo)


@ray_tpu_torch.remote
def _external_env(address, episodes):
    """The EXTERNAL environment: lives in another process, steps its own
    simulator, and asks the server for every action."""
    from ray_tpu_torch.rllib import PolicyClient

    client = PolicyClient(tuple(address))
    env = CartPoleVectorEnv(num_envs=1, seed=7)
    total = 0
    for _ in range(episodes):
        eid = client.start_episode()
        obs = env.reset(seed=7)[0]
        for _ in range(60):
            a = client.get_action(eid, obs)
            assert a in (0, 1)
            next_obs, rew, term, trunc = env.step(np.array([a]))
            client.log_returns(eid, float(rew[0]))
            total += 1
            if term[0] or trunc[0]:
                client.end_episode(eid, next_obs[0])
                break
            obs = env.current_obs()[0]
        else:
            client.end_episode(eid, env.current_obs()[0])
    client.close()
    return total


def test_policy_client_server_roundtrip():
    """ray: rllib/env/policy_client.py:58 — an external env process drives
    the episode loop over TCP; the server's drained transitions feed a
    replay buffer."""
    from ray_tpu_torch.rllib import PolicyServer

    algo = (
        DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_runner=2, rollout_length=8)
        .debugging(seed=3)
        .build(device="cpu")
    )
    server = PolicyServer(algo.compute_single_action, port=0)
    try:
        steps = ray_tpu_torch.get(_external_env.remote(server.address, 4), timeout=120)
        assert steps >= 4  # actions round-tripped over TCP
        batch = server.drain()
        assert batch is not None and len(batch["actions"]) >= steps - 4
        algo.buffer.add_batch(
            batch["obs"], batch["actions"], batch["rewards"],
            batch["next_obs"], batch["dones"],
        )
        assert algo.buffer.size == len(batch["actions"])
    finally:
        server.close()
        _stop_and_check(algo)


class TinyModule(RLModule):
    """A user RLModule: one tanh layer, a policy and a value head."""

    def init(self, generator, obs_size, num_actions):
        def normal(*shape):
            return torch.randn(shape, generator=generator, device=generator.device)

        return {"w1": normal(obs_size, 32) * 0.1, "pi": normal(32, num_actions) * 0.01,
                "vf": normal(32, 1) * 0.1}

    def forward(self, params, obs):
        h = torch.tanh(obs @ params["w1"])
        return h @ params["pi"], (h @ params["vf"])[..., 0]


def test_custom_rl_module_plugs_into_ppo():
    """A user RLModule (ray: core/rl_module/rl_module.py) drops into PPO
    via config.rl_module() and is used by BOTH learner and env runners."""
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_runner=4, rollout_length=32)
        .rl_module(TinyModule())
        .debugging(seed=1)
        .build(device="cpu")
    )
    try:
        result = algo.train()
        assert result["num_env_steps_sampled"] > 0
        assert "w1" in algo.get_weights()  # the CUSTOM params are training
        assert np.isfinite(result["total_loss"])
    finally:
        _stop_and_check(algo)


def test_offline_data_round_trips_through_parquet(tmp_path):
    """write_experiences -> OfflineData gives the logged columns back, and
    an offline DQN (no env, no runners) fills its buffer with all of them
    and trains."""
    from ray_tpu_torch.rllib import OfflineData, write_experiences

    rng = np.random.default_rng(0)
    n = 96
    batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int64),
             "rewards": rng.normal(size=n).astype(np.float32),
             "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
             "dones": (rng.random(n) < 0.1).astype(np.float32)}
    path = str(tmp_path / "exp")
    assert write_experiences(batch, path)
    data = OfflineData(path)
    assert (data.size, data.obs_size, data.num_actions) == (n, 4, 2)
    cols = data._materialize()
    order = np.lexsort(cols["obs"].T)
    ref = np.lexsort(batch["obs"].T)
    for k in batch:
        assert np.array_equal(cols[k][order], batch[k][ref]), k
    algo = (DQNConfig().offline_data(path)
            .training(learn_batch_size=32, updates_per_iteration=2)
            .build(device="cpu"))
    try:
        assert algo.runners == [] and algo.buffer.size == n
        out = algo.train()
        assert out["num_env_steps_sampled"] == 0 and np.isfinite(out["loss"])
    finally:
        algo.stop()


# The port's offline DQN against the JAX package's over 30 iterations of 64
# updates from one carried-over state: f32 sums in another order,
# compounded by 1,920 Adam steps. Measured on this test's data: Q up to
# 9.2e-6 of the largest |Q| (15.0), and each iteration's mean loss up to
# 2.7e-5 relative (iteration 2, a loss of 0.006: a mean of small Huber
# terms carries the Q drift as a larger relative error); on a logged
# behaviour policy's data, Q up to 1.7e-5. 1e-4 is 3.7 times the largest.
OFFLINE_RTOL = 1e-4


def test_offline_dqn_tracks_jax_from_a_carried_over_state():
    """The offline DQN path (a full replay buffer, update_many, the target
    sync every 2 iterations) of the port from the JAX learner's initial
    state, carried over by learner_state_from_numpy, stays with the JAX
    package's on the same batches for 30 iterations: Q on 256 probe states
    within OFFLINE_RTOL of its largest magnitude, the same greedy action
    wherever JAX's gap is clear of that, the losses within OFFLINE_RTOL.
    The seeded inits of the two packages are different draws (jax.random
    cannot be reproduced)."""
    import jax

    from ray_tpu.rllib import DQNConfig as JaxDQNConfig
    from ray_tpu.rllib import dqn as jax_dqn
    from ray_tpu.rllib.policy import apply_policy as jax_apply
    from ray_tpu_torch.models import learner_state_from_numpy
    from ray_tpu_torch.rllib import ReplayBuffer, dqn

    env = CartPoleVectorEnv(16, seed=0)
    rng = np.random.default_rng(0)
    buffer = ReplayBuffer(16 * 200, 4)
    obs = env.reset(seed=0)
    for _ in range(200):
        actions = rng.integers(0, 2, 16)
        final_obs, rewards, terminated, _ = env.step(actions)
        buffer.add_batch(obs, actions, rewards, final_obs, terminated.astype(np.float32))
        obs = env.current_obs()
    kw = dict(lr=1e-3, learn_batch_size=128, updates_per_iteration=64, target_sync_every=2)
    j_init, j_update, j_sync = jax_dqn._make_learner(JaxDQNConfig().training(**kw), 4, 2)
    _, t_update, t_sync = dqn._make_learner(DQNConfig().training(**kw), 4, 2, device="cpu")
    j_state = j_init(1)
    t_state = learner_state_from_numpy(jax.tree_util.tree_map(np.asarray, j_state),
                                       device="cpu")
    probe = _obs(256)
    sample_rng = np.random.default_rng(1)
    for it in range(1, 31):
        samples = [buffer.sample(128, sample_rng) for _ in range(64)]
        batches = tuple(np.stack([x[i] for x in samples]) for i in range(5))
        j_state, j_loss = j_update(j_state, batches)
        t_state, t_loss = t_update(t_state, batches)
        if it % 2 == 0:
            j_state, t_state = j_sync(j_state), t_sync(t_state)
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=OFFLINE_RTOL)
        j_q = np.asarray(jax_apply(j_state["params"], probe)[0])
        with torch.no_grad():
            t_q = apply_policy(t_state["params"], torch.from_numpy(probe))[0].numpy()
        bound = OFFLINE_RTOL * max(1.0, float(np.abs(j_q).max()))
        np.testing.assert_allclose(t_q, j_q, atol=bound, rtol=0)
        clear = np.abs(j_q[:, 0] - j_q[:, 1]) > 2 * bound
        assert (t_q.argmax(1) == j_q.argmax(1))[clear].all()


def test_offline_dqn_class_is_jax_s_from_a_carried_over_state(tmp_path):
    """The port's DQN class offline, from the JAX learner's initial state,
    is the JAX package's offline DQN on the same logged data: the buffer
    filled in the reader's order, each iteration's 64 minibatches drawn
    from the seeded generator, the target synced every 2 iterations, then
    the greedy evaluation (epsilon 0, a runner seeded seed + 31337). The
    reference is DQN.train's dataflow composed of the JAX package's
    learner, replay buffer and runner in this process, on the columns the
    reader gives (`rllib/offline.py` is a copy of the source's); after 30
    iterations the weights agree within OFFLINE_RTOL and the evaluation's
    returns are the same. From the same state the two offline paths are
    one path: an evaluation that differs between the packages comes from
    the seeded init (the slow case's seeds, CHANGES.md)."""
    import jax

    from ray_tpu.rllib import DQNConfig as JaxDQNConfig
    from ray_tpu.rllib import dqn as jax_dqn
    from ray_tpu_torch.models import learner_state_from_numpy
    from ray_tpu_torch.rllib import OfflineData, write_experiences

    env = CartPoleVectorEnv(16, seed=0)
    rng = np.random.default_rng(0)
    cols = {k: [] for k in ("obs", "actions", "rewards", "next_obs", "dones")}
    obs = env.reset(seed=0)
    for _ in range(100):
        actions = rng.integers(0, 2, 16)
        final_obs, rewards, terminated, _ = env.step(actions)
        for k, v in zip(cols, (obs, actions, rewards, final_obs, terminated.astype(np.float32))):
            cols[k].append(v)
        obs = env.current_obs()
    path = str(tmp_path / "exp")
    assert write_experiences({k: np.concatenate(v) for k, v in cols.items()}, path)

    kw = dict(lr=1e-3, learn_batch_size=128, updates_per_iteration=64, target_sync_every=2,
              epsilon_start=0.0, epsilon_end=0.0)
    seed, iterations = 1, 30
    j_init, j_update, j_sync = jax_dqn._make_learner(JaxDQNConfig().training(**kw), 4, 2)
    j_state = j_init(seed)
    algo = DQNConfig().offline_data(path).training(**kw).debugging(seed=seed).build(device="cpu")
    try:
        algo._state = learner_state_from_numpy(jax.tree_util.tree_map(np.asarray, j_state),
                                               device="cpu")
        for _ in range(iterations):
            algo.train()
        t_weights = algo.get_weights()
        t_eval = algo.evaluate(num_steps=150, env="CartPole-v1")["evaluation"]
    finally:
        algo.stop()

    data = OfflineData(path)._materialize()
    buffer = jax_dqn.ReplayBuffer(max(JaxDQNConfig().buffer_capacity, len(data["actions"])), 4)
    buffer.add_batch(data["obs"], data["actions"], data["rewards"], data["next_obs"],
                     data["dones"])
    sample_rng = np.random.default_rng(seed)
    for it in range(1, iterations + 1):
        samples = [buffer.sample(128, sample_rng) for _ in range(64)]
        j_state, _ = j_update(j_state, tuple(np.stack([x[i] for x in samples]) for i in range(5)))
        if it % 2 == 0:
            j_state = j_sync(j_state)
    j_weights = jax.tree_util.tree_map(np.asarray, j_state["params"])
    runner = jax_dqn._DQNRunner("CartPole-v1", 8, seed + 31337)
    j_returns = runner.collect(j_weights, 150, 0.0)["episode_returns"]

    for t, j in zip(tree_leaves(t_weights), jax.tree_util.tree_leaves(j_weights)):
        bound = OFFLINE_RTOL * max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(np.asarray(t), j, atol=bound, rtol=0)
    assert t_eval["episodes"] == len(j_returns) > 0
    assert t_eval["episode_reward_mean"] == float(np.mean(j_returns))


# -- the source's slow cases -------------------------------------------------------------


@pytest.mark.slow  # dqn_cartpole_learns is the fast learning twin
def test_ppo_cartpole_learns():
    """PPO on CartPole with 2 rollout workers must clearly learn
    (reference: rllib/tuned_examples/ppo/cartpole-ppo.yaml, --as-test)."""
    config = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_runner=8, rollout_length=64)
        .training(lr=1e-3, num_epochs=8, minibatch_size=128, entropy_coeff=0.005)
        .debugging(seed=7)
    )
    algo = config.build(device="cpu")
    try:
        first = None
        best = 0.0
        for _ in range(100):
            result = algo.train()
            if first is None and result["episode_reward_mean"] > 0:
                first = result["episode_reward_mean"]
            best = max(best, result["episode_reward_mean"])
            if best >= 120.0:
                break
        assert first is not None, "no episodes completed"
        assert best >= 120.0, f"PPO failed to learn: first={first:.1f}, best={best:.1f}"
        assert result["num_env_steps_sampled"] > 0
        assert np.isfinite(result["total_loss"])
    finally:
        _stop_and_check(algo)


@pytest.mark.slow  # impala's async learner re-covers the PPO loop; ppo/dqn cartpole stay tier-1 as the fast learning twins
def test_impala_cartpole_learns():
    """IMPALA with 2 ASYNC env runners + V-trace must clearly learn
    (reference: rllib/tuned_examples/impala/cartpole-impala.yaml)."""
    algo = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_runner=8, rollout_length=16)
        .training(updates_per_iteration=16)
        .debugging(seed=11)
        .build(device="cpu")
    )
    try:
        best = 0.0
        lag_seen = 0.0
        for _ in range(80):
            r = algo.train()
            best = max(best, r["episode_reward_mean"])
            lag_seen = max(lag_seen, r["avg_weights_lag"])
            if best >= 120.0:
                break
        assert best >= 120.0, f"IMPALA failed to learn: best={best:.1f}"
        # The pipeline is genuinely async: consumed trajectories were
        # sampled under stale weights at least some of the time.
        assert lag_seen > 0.0
    finally:
        _stop_and_check(algo)


@pytest.mark.slow  # impala_runner_survives_env_error is the fast twin
def test_impala_degrades_when_runner_actor_dies():
    """A dead runner ACTOR (not a task error) is dropped from the pipeline
    and training continues on the survivors — a permanently erroring ref
    must not starve healthy runners (livelock regression)."""
    algo = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_runner=4, rollout_length=8)
        .training(updates_per_iteration=4)
        .debugging(seed=2)
        .build(device="cpu")
    )
    try:
        algo.train()
        dead = algo.runners[0]._actor_id
        ray_tpu_torch.kill(algo.runners[0])
        # Until the runtime has failed the dead runner's task, train() can
        # take all its updates from the survivor (a race the source's test
        # shares): wait for the death to land first.
        import time

        deadline = time.monotonic() + 30
        while _alive([dead]) and time.monotonic() < deadline:
            time.sleep(0.05)
        r = algo.train()  # must not raise or hang
        assert r["num_dead_env_runners"] == 1
        assert len(algo.runners) == 1
        assert r["num_env_steps_sampled"] > 0
    finally:
        _stop_and_check(algo)


@pytest.mark.slow  # multi-agent rides the same PPO core that test_ppo_cartpole_learns pins tier-1
def test_multi_agent_ppo_learns_shared_and_independent():
    """Multi-agent PPO (ray: rllib/env/multi_agent_env.py + policy map):
    2 agents with INDEPENDENT policies must both learn; a shared-policy
    mapping must pool experience into one param set."""
    algo = (
        MultiAgentPPOConfig()
        .environment(lambda num_envs, seed: MultiAgentCartPole(num_envs, 2, seed))
        .multi_agent({"agent_0": "p0", "agent_1": "p1"})
        .env_runners(num_env_runners=2, num_envs_per_runner=8, rollout_length=32)
        .debugging(seed=5)
        .build(device="cpu")
    )
    try:
        assert set(algo.get_weights()) == {"p0", "p1"}
        best = {"agent_0": 0.0, "agent_1": 0.0}
        for _ in range(60):
            r = algo.train()
            for aid in best:
                best[aid] = max(best[aid], r.get(f"{aid}/episode_reward_mean", 0.0))
            if min(best.values()) >= 60.0:
                break
        assert min(best.values()) >= 60.0, best
    finally:
        _stop_and_check(algo)

    shared = (
        MultiAgentPPOConfig()
        .environment(lambda num_envs, seed: MultiAgentCartPole(num_envs, 2, seed))
        .multi_agent({"agent_0": "shared", "agent_1": "shared"})
        .env_runners(num_env_runners=1, num_envs_per_runner=4, rollout_length=8)
        .debugging(seed=1)
        .build(device="cpu")
    )
    try:
        assert set(shared.get_weights()) == {"shared"}
        r = shared.train()
        # Pooled batch: one policy consumed BOTH agents' experience.
        assert "shared/total_loss" in r
    finally:
        _stop_and_check(shared)


# The offline DQN case's seeds, (behaviour, offline): its source's (3, 1)
# and two more, fixed before any run. The greedy evaluation's runner takes
# its seed from the offline one (`DQN.evaluate`: seed + 31337).
OFFLINE_DQN_SEEDS = ((3, 1), (4, 2), (5, 3))


def offline_dqn_evaluation(path: str, behaviour_seed: int, offline_seed: int) -> float:
    """tests/test_rllib.py's offline DQN run at the given seeds: a partly
    trained online DQN logs its epsilon-greedy stream to `path`, a DQN
    learns from that log alone, and its greedy policy's mean return over
    150 CartPole steps is returned."""
    from ray_tpu_torch.rllib import write_experiences

    # Log behavioral data: a partially-trained online DQN's epsilon-greedy
    # stream (mixed-quality data, the offline-RL setting).
    behav = (
        DQNConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_runner=8, rollout_length=32)
        .training(lr=1e-3, learn_batch_size=128, updates_per_iteration=64,
                  epsilon_decay_iters=25, target_sync_every=2)
        .debugging(seed=behaviour_seed)
        .build(device="cpu")
    )
    try:
        for _ in range(60):
            r = behav.train()
            if r["episode_reward_mean"] >= 80:
                break
        assert r["episode_reward_mean"] >= 80, "behavioral policy failed to train"
        # Log the trained policy's stream with exploration noise (mixed data).
        w = ray_tpu_torch.put(behav.get_weights())
        outs = ray_tpu_torch.get(
            [r.collect.remote(w, 500, 0.2) for r in behav.runners], timeout=300
        )
    finally:
        _stop_and_check(behav)
    batch = {
        k: np.concatenate([o[k] for o in outs])
        for k in ("obs", "actions", "rewards", "next_obs", "dones")
    }
    assert write_experiences(batch, path)

    # Offline training: no env, no runners.
    algo = (
        DQNConfig()
        .offline_data(path)
        .training(lr=1e-3, learn_batch_size=128, updates_per_iteration=64,
                  target_sync_every=2, epsilon_start=0.0, epsilon_end=0.0)
        .debugging(seed=offline_seed)
        .build(device="cpu")
    )
    try:
        assert algo.runners == []  # nothing steps an environment
        assert algo.buffer.size == len(batch["actions"])
        for _ in range(30):
            out = algo.train()
        assert out["num_env_steps_sampled"] == 0
        ev = algo.evaluate(num_steps=150, env="CartPole-v1")["evaluation"]
    finally:
        algo.stop()
    return ev["episode_reward_mean"]


@pytest.mark.slow  # dqn_cartpole_learns covers the online DQN path fast
def test_offline_dqn_learns_from_logged_data(tmp_path):
    """ray: rllib/offline/dataset_reader.py — train purely from logged
    experiences (no env stepping during training), then evaluate the
    learned greedy policy in the env and beat a reward threshold."""
    means = [offline_dqn_evaluation(str(tmp_path / f"exp{b}_{o}"), b, o)
             for b, o in OFFLINE_DQN_SEEDS]
    # Random CartPole averages ~20 reward; demand clear offline learning.
    assert float(np.median(means)) >= 50, means


@pytest.mark.slow  # 37s learner soak; test_ppo_cartpole_learns is the tier-1 twin
def test_appo_cartpole_learns():
    """APPO (async PPO: IMPALA pipeline + clipped surrogate on V-trace
    advantages; ray: rllib/algorithms/appo) must clearly learn."""
    algo = (
        APPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_runner=8, rollout_length=64)
        .training(lr=7e-4, updates_per_iteration=12, clip_param=0.3,
                  entropy_coeff=3e-3)
        .debugging(seed=5)
        .build(device="cpu")
    )
    try:
        best = 0.0
        for _ in range(60):
            result = algo.train()
            best = max(best, result["episode_reward_mean"])
            if best >= 100.0:
                break
        assert best >= 100.0, f"APPO failed to learn: best={best:.1f}"
        assert result["avg_weights_lag"] >= 0  # the async pipeline ran
    finally:
        _stop_and_check(algo)


@pytest.mark.slow  # 23s continuous-action soak; test_dqn_cartpole_learns keeps off-policy tier-1
def test_sac_pendulum_learns():
    """SAC (squashed-Gaussian actor, twin Q, alpha auto-tune; ray:
    rllib/algorithms/sac) improves Pendulum swing-up well past random."""
    algo = (
        SACConfig()
        .environment("Pendulum-v1")
        .env_runners(num_env_runners=1, num_envs_per_runner=16, rollout_length=25)
        .training(learning_starts=800, updates_per_iteration=200,
                  batch_size=128, lr=1e-3)
        .debugging(seed=0)
        .build(device="cpu")
    )
    try:
        best = -1e9
        for _ in range(40):
            result = algo.train()
            if result["episode_reward_mean"]:
                best = max(best, result["episode_reward_mean"])
            if best > -1000.0:
                break
        # random policy sits near -1200..-1500; learning clears -1000
        assert best > -1000.0, f"SAC failed to improve: best={best:.1f}"
        assert 0.0 < result["alpha"] < 2.0  # temperature auto-tuned
    finally:
        _stop_and_check(algo)
