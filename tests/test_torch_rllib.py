"""The port's RLlib (`ray_tpu_torch.rllib`) against the JAX package's
(`ray_tpu.rllib`), on the CPU.

The numpy parts (GAE, the envs, the replay buffers) must equal the JAX
package's exactly. The networks, runners, V-trace and every learner's update
take weights carried over from the JAX tree (`learner_state_from_numpy`)
and, where the JAX side draws from `jax.random` (PPO's permutations, SAC's
noise), JAX's draws, fed in by replacing the port's one draw function:
`jax.random` cannot be reproduced, so the port's own draws are held by
their distribution only (the orthogonal init) or made irrelevant (a policy
head whose logit gap makes sampling deterministic).

Bounds: the forward passes and V-trace are f32 sums in another order, 1e-6
of the output's largest magnitude (at least 1). The runners' values and GAE
go through 64x64 f32 products and a recursion of up to 24 steps: 1e-5.
One update of each learner: losses and metrics within 1e-5 relative, with
a floor of 1e-6 absolute for a metric that is a mean of terms of both
signs near zero (the policy loss of standardised advantages); parameters
and Adam moments within 1e-5 absolute (an Adam step moves an element by
about the learning rate, 1e-3 or 3e-4, so a reordered f32 sum shows as
1e-7-1e-6 there).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import appo as jax_appo
from ray_tpu.rllib import dqn as jax_dqn
from ray_tpu.rllib import env as jax_env
from ray_tpu.rllib import env_runner as jax_runner
from ray_tpu.rllib import impala as jax_impala
from ray_tpu.rllib import multi_agent as jax_ma
from ray_tpu.rllib import policy as jax_policy
from ray_tpu.rllib import ppo as jax_ppo
from ray_tpu.rllib import rl_module as jax_rl_module
from ray_tpu.rllib import sac as jax_sac
from ray_tpu.rllib import sample_batch as jax_sample_batch
from ray_tpu_torch.models import learner_state_from_numpy
from ray_tpu_torch.rllib import (
    APPOConfig,
    CartPoleVectorEnv,
    ContinuousMLPModule,
    ContinuousReplayBuffer,
    DQNConfig,
    EnvRunner,
    IMPALAConfig,
    LearnerGroup,
    MultiAgentCartPole,
    MultiAgentEnvRunner,
    MultiAgentPPOConfig,
    PendulumVectorEnv,
    PPOConfig,
    ReplayBuffer,
    SACConfig,
    SampleBatch,
    TorchPolicy,
    apply_policy,
    compute_gae,
    init_policy_params,
    make_appo_learner,
    make_impala_learner,
    make_policy_learners,
    make_sac_learner,
    vtrace,
)
from ray_tpu_torch.rllib import dqn, ppo, sac
from ray_tpu_torch.rllib import multi_agent as port_ma
from ray_tpu_torch.rllib.sample_batch import ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS

FWD_TOL = 1e-6
RUNNER_TOL = 1e-5
UPDATE_RTOL = 1e-5
METRIC_ATOL = 1e-6
PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The learners' [128, 64] products gain nothing from intra-op threads,
    and on a loaded host (the suite's parallel workers) the threads'
    synchronisation at each of the learning run's ~5x10^5 small ops costs
    far more than the ops (389 s against 6-10 s): one thread, restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(params):
    """A JAX numpy parameter tree as the port's tensors (requiring grad)."""
    return learner_state_from_numpy({"params": params}, device="cpu")["params"]


def assert_tree_close(ours, theirs, atol, path="", rtol=0.0):
    """Leaf by leaf, matched by key or index (JAX orders dict keys sorted,
    the port by insertion)."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            assert_tree_close(ours[k], theirs[k], atol, f"{path}.{k}", rtol)
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_tree_close(a, b, atol, f"{path}.{i}", rtol)
    else:
        a = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
        np.testing.assert_allclose(a, np.asarray(theirs), atol=atol, rtol=rtol, err_msg=path)


def _assert_adam_close(ours, theirs_chain):
    """The port's {"count", "mu", "nu"} against optax.adam's chain state."""
    adam_state = theirs_chain[0]
    assert ours["count"] == int(adam_state.count)
    assert_tree_close(ours["mu"], adam_state.mu, PARAM_ATOL, "mu")
    assert_tree_close(ours["nu"], adam_state.nu, PARAM_ATOL, "nu")


def assert_close_to_scale(ours, theirs, tol=FWD_TOL):
    """max |ours - theirs| <= tol * max(1, max |theirs|): an f32 sum in
    another order errs by a share of its terms' size, not of its value."""
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape
    err, scale = np.abs(ours - theirs).max(), max(1.0, np.abs(theirs).max())
    assert err <= tol * scale, f"max |diff| {err:.3g} > {tol} x {scale:.3g}"


def _assert_metrics_close(ours, theirs):
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=UPDATE_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)


# -- numpy parts: equal ------------------------------------------------------


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(0)
    T, N = 17, 5
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.2
    boot = rng.normal(size=N).astype(np.float32)
    ours = compute_gae(rewards, values, dones, boot, 0.97, 0.9)
    theirs = jax_sample_batch.compute_gae(rewards, values, dones, boot, 0.97, 0.9)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    b1 = SampleBatch({"x": np.arange(5)})
    assert list(SampleBatch.concat_samples([b1, b1])["x"]) == list(np.arange(5)) * 2


@pytest.mark.parametrize("kind", ["cartpole", "pendulum", "multi_agent"])
def test_envs_match_jax(kind):
    """The same seeds and actions give the same observations, rewards,
    terminations, truncations and episode returns."""
    if kind == "cartpole":
        ours, theirs = CartPoleVectorEnv(6, seed=3), jax_env.CartPoleVectorEnv(6, seed=3)
    elif kind == "pendulum":
        ours, theirs = PendulumVectorEnv(6, seed=3), jax_env.PendulumVectorEnv(6, seed=3)
    else:
        ours, theirs = MultiAgentCartPole(6, 2, seed=3), jax_ma.MultiAgentCartPole(6, 2, seed=3)
    rng = np.random.default_rng(5)
    _assert_equal(ours.reset(seed=4), theirs.reset(seed=4))
    for _ in range(250):
        if kind == "cartpole":
            act = rng.integers(0, 2, 6)
        elif kind == "pendulum":
            act = rng.uniform(-2, 2, (6, 1)).astype(np.float32)
        else:
            act = {a: rng.integers(0, 2, 6) for a in ours.agent_ids}
        _assert_equal(ours.step(act), theirs.step(act))
        _assert_equal(ours.current_obs(), theirs.current_obs())
    _assert_equal(ours.drain_episode_returns(), theirs.drain_episode_returns())


def _assert_equal(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _assert_equal(a[k], b[k])
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_replay_buffers_match_jax():
    rng = np.random.default_rng(2)
    ours, theirs = ReplayBuffer(50, 4), jax_dqn.ReplayBuffer(50, 4)
    c_ours, c_theirs = ContinuousReplayBuffer(50, 3, 1), jax_sac.ContinuousReplayBuffer(50, 3, 1)
    for _ in range(7):  # wraps the ring
        n = 11
        cols = (rng.normal(size=(n, 4)).astype(np.float32), rng.integers(0, 2, n),
                rng.normal(size=n).astype(np.float32), rng.normal(size=(n, 4)).astype(np.float32),
                (rng.random(n) < 0.1).astype(np.float32))
        ours.add_batch(*cols)
        theirs.add_batch(*cols)
        ccols = (rng.normal(size=(n, 3)), rng.normal(size=(n, 1)), rng.normal(size=n),
                 rng.normal(size=(n, 3)), (rng.random(n) < 0.1))
        c_ours.add_batch(*ccols)
        c_theirs.add_batch(*ccols)
    assert (ours.size, ours.idx) == (theirs.size, theirs.idx)
    _assert_equal(ours.sample(32, np.random.default_rng(9)),
                  theirs.sample(32, np.random.default_rng(9)))
    _assert_equal(c_ours.sample(32, np.random.default_rng(9)),
                  c_theirs.sample(32, np.random.default_rng(9)))


# -- networks ------------------------------------------------------------------


def test_apply_policy_and_log_probs_match_jax():
    params = _np(jax_policy.init_policy_params(jax.random.PRNGKey(0), 4, 2))
    obs = np.random.default_rng(1).normal(size=(32, 4)).astype(np.float32)
    logits, value = jax_policy.apply_policy(params, jnp.asarray(obs))
    with torch.no_grad():
        ours_logits, ours_value = apply_policy(_carry(params), torch.as_tensor(obs))
    assert_close_to_scale(ours_logits, logits)
    assert_close_to_scale(ours_value, value)
    assert_close_to_scale(torch.log_softmax(ours_logits, 1), jax.nn.log_softmax(logits))


def test_continuous_module_pi_and_q_match_jax():
    jmod, mod = jax_rl_module.ContinuousMLPModule((32, 32)), ContinuousMLPModule((32, 32))
    params = _np(jmod.init(jax.random.PRNGKey(1), 3, 1))
    # A pi head that drives some log_std past both clips.
    params["pi"][-1]["w"] = params["pi"][-1]["w"] * 3000.0
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(64, 3)).astype(np.float32)
    act = rng.uniform(-2, 2, (64, 1)).astype(np.float32)
    ours_p = _carry(params)
    with torch.no_grad():
        mean, log_std = mod.pi(ours_p, torch.as_tensor(obs))
        q1, q2 = mod.q(ours_p, torch.as_tensor(obs), torch.as_tensor(act))
    jmean, jlog_std = jmod.pi(params, jnp.asarray(obs))
    jq1, jq2 = jmod.q(params, jnp.asarray(obs), jnp.asarray(act))
    assert float(jnp.min(jlog_std)) == -20.0 and float(jnp.max(jlog_std)) == 2.0
    for a, b in ((mean, jmean), (log_std, jlog_std), (q1, jq1), (q2, jq2)):
        assert_close_to_scale(a, b)


def _gram_is_scaled_identity(w: torch.Tensor, scale: float):
    w = w.double()
    g = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
    torch.testing.assert_close(g, scale ** 2 * torch.eye(g.shape[0], dtype=torch.float64),
                               atol=1e-5 * max(scale ** 2, 1.0), rtol=0)


def test_orthogonal_init_is_jax_s_in_distribution():
    """jax.random cannot be reproduced: the init is held by W^T W (W W^T
    where in < out) = scale^2 I and zero biases."""
    gen = torch.Generator().manual_seed(0)
    p = init_policy_params(gen, 4, 2, (64, 64))
    for layer, scale in zip(p["torso"] + [p["pi"], p["vf"]], [2 ** 0.5] * 2 + [0.01, 1.0]):
        _gram_is_scaled_identity(layer["w"], scale)
        assert not layer["b"].any()
    c = ContinuousMLPModule((32, 32)).init(gen, 3, 1)
    for net in ("pi", "q1", "q2"):
        scales = [2 ** 0.5, 2 ** 0.5, 0.01 if net == "pi" else 1.0]
        for layer, scale in zip(c[net], scales):
            _gram_is_scaled_identity(layer["w"], scale)
            assert not layer["b"].any()
    # Another generator state draws other weights.
    assert not torch.equal(init_policy_params(gen, 4, 2)["pi"]["w"], p["pi"]["w"])


# -- runners: the same trajectories under a deterministic policy ---------------

MAX_STEPS = 9  # truncates some CartPoles before their pole falls


class _ShortCartPole(CartPoleVectorEnv):
    MAX_STEPS = MAX_STEPS


class _JaxShortCartPole(jax_env.CartPoleVectorEnv):
    MAX_STEPS = MAX_STEPS


def _deterministic(params):
    """A pi head whose logits are (0, 60) whatever the observation: both
    samplers draw action 1 (a Gumbel draw of f32 noise spans < 22)."""
    params = jax.tree_util.tree_map(np.array, params)
    params["pi"]["w"][:] = 0.0
    params["pi"]["b"][:] = [0.0, 60.0]
    return params


def _runner_weights():
    return _deterministic(_np(jax_policy.init_policy_params(jax.random.PRNGKey(4), 4, 2)))


def test_env_runner_sample_matches_jax():
    w = _runner_weights()
    ours = EnvRunner(_ShortCartPole, 16, 24, seed=3, device="cpu")
    theirs = jax_runner.EnvRunner(_JaxShortCartPole, 16, 24, seed=3)
    for _ in range(2):
        a, b = ours.sample(w), theirs.sample(w)
        assert a["steps"] == b["steps"]
        assert a["episode_returns"] == b["episode_returns"]
        np.testing.assert_array_equal(a["batch"][OBS], b["batch"][OBS])
        np.testing.assert_array_equal(a["batch"][ACTIONS], b["batch"][ACTIONS])
        assert a["batch"][ACTIONS].dtype == np.int64
        for k in (LOGPS, ADVANTAGES, RETURNS):
            np.testing.assert_allclose(a["batch"][k], b["batch"][k], atol=RUNNER_TOL,
                                       rtol=RUNNER_TOL)
    # The rollouts held both cuts: a constant push drops the pole after 8-10
    # steps, so episodes end by termination at 8 and by truncation (whose
    # reward the runner bootstraps) at 9.
    assert {MAX_STEPS - 1, MAX_STEPS} <= set(b["episode_returns"])


def test_env_runner_sample_trajectory_matches_jax():
    w = _runner_weights()
    ours = EnvRunner(_ShortCartPole, 16, 24, seed=5, device="cpu")
    theirs = jax_runner.EnvRunner(_JaxShortCartPole, 16, 24, seed=5)
    a, b = ours.sample_trajectory(w, 3), theirs.sample_trajectory(w, 3)
    assert a["weights_version"] == b["weights_version"] == 3
    for k in b["batch"]:
        if k == LOGPS:
            np.testing.assert_allclose(a["batch"][k], b["batch"][k], atol=RUNNER_TOL)
        else:
            np.testing.assert_array_equal(a["batch"][k], b["batch"][k])
    term, done = b["batch"]["terminateds"], b["batch"]["dones"]
    assert term.any() and (done & ~term).any()  # terminations and truncations


def _ma_creator(mod):
    def creator(num_envs, seed):
        env = mod.MultiAgentCartPole(num_envs=num_envs, num_agents=2, seed=seed)
        env.max_steps = MAX_STEPS
        return env

    return creator


@pytest.mark.parametrize("mapping", [{"agent_0": "shared", "agent_1": "shared"},
                                     {"agent_0": "p0", "agent_1": "p1"}],
                         ids=["shared", "independent"])
def test_multi_agent_runner_matches_jax(mapping):
    ours = MultiAgentEnvRunner(_ma_creator(port_ma), 16, 24, mapping, seed=2, device="cpu")
    theirs = jax_ma.MultiAgentEnvRunner(_ma_creator(jax_ma), 16, 24, mapping, seed=2)
    pids = sorted(set(mapping.values()))
    w = {pid: _deterministic(_np(jax_policy.init_policy_params(jax.random.PRNGKey(i), 4, 2)))
         for i, pid in enumerate(pids)}
    a, b = ours.sample(w), theirs.sample(w)
    assert a["steps"] == b["steps"]
    _assert_equal(a["episode_returns"], b["episode_returns"])
    assert set(a["batches"]) == set(b["batches"]) == set(pids)
    for pid in pids:
        for k in (OBS, ACTIONS):
            np.testing.assert_array_equal(a["batches"][pid][k], b["batches"][pid][k])
        for k in (LOGPS, ADVANTAGES, RETURNS):
            np.testing.assert_allclose(a["batches"][pid][k], b["batches"][pid][k],
                                       atol=RUNNER_TOL, rtol=RUNNER_TOL)


# -- V-trace -----------------------------------------------------------------------


def _vtrace_case(name):
    rng = np.random.default_rng(0)
    if name == "random":
        T, N = 12, 5
        term = rng.random((T, N)) < 0.1
        done = term | (rng.random((T, N)) < 0.1)
        return dict(target_logps=rng.normal(size=(T, N)) - 1,
                    behavior_logps=rng.normal(size=(T, N)) - 1,
                    rewards=rng.normal(size=(T, N)), values=rng.normal(size=(T, N)),
                    next_values=rng.normal(size=(T, N)), terminateds=term, dones=done, gamma=0.95)
    if name == "termination":  # tests/test_rllib.py::test_vtrace_cuts_at_termination
        T, N = 3, 1
        term = np.array([[True], [False], [False]])
        return dict(target_logps=np.zeros((T, N)), behavior_logps=np.zeros((T, N)),
                    rewards=np.ones((T, N)), values=np.zeros((T, N)),
                    next_values=np.full((T, N), 9.0), terminateds=term, dones=term, gamma=0.9)
    # tests/test_rllib.py::test_vtrace_bootstraps_through_truncation
    T, N = 2, 1
    return dict(target_logps=np.zeros((T, N)), behavior_logps=np.zeros((T, N)),
                rewards=np.ones((T, N)), values=np.zeros((T, N)),
                next_values=np.full((T, N), 5.0), terminateds=np.zeros((T, N), bool),
                dones=np.array([[True], [False]]), gamma=0.9)


@pytest.mark.parametrize("name", ["random", "termination", "truncation"])
def test_vtrace_matches_jax(name):
    case = _vtrace_case(name)
    gamma = case.pop("gamma")
    arrays = {k: (v if v.dtype == bool else v.astype(np.float32)) for k, v in case.items()}
    vs, adv = vtrace(**{k: torch.as_tensor(v) for k, v in arrays.items()}, gamma=gamma)
    jvs, jadv = jax_impala.vtrace(**{k: jnp.asarray(v) for k, v in arrays.items()}, gamma=gamma)
    assert_close_to_scale(vs, jvs)
    assert_close_to_scale(adv, jadv)
    if name == "termination":
        assert vs[0, 0] == pytest.approx(1.0) and adv[0, 0] == pytest.approx(1.0)
    if name == "truncation":
        assert vs[0, 0] == pytest.approx(1.0 + 0.9 * 5.0)


# -- one update of each learner, from the JAX state ---------------------------------


def _ppo_config(mod):
    return mod.PPOConfig().training(lr=1e-3, num_epochs=2, minibatch_size=64,
                                    entropy_coeff=0.005)


def _ppo_batch(B=256):
    rng = np.random.default_rng(3)
    return {
        OBS: rng.normal(size=(B, 4)).astype(np.float32),
        ACTIONS: rng.integers(0, 2, B),
        LOGPS: (-0.69 + 0.1 * rng.normal(size=B)).astype(np.float32),
        ADVANTAGES: (1.0 + 3.0 * rng.normal(size=B)).astype(np.float32),
        RETURNS: (5.0 * rng.normal(size=B)).astype(np.float32),
    }


def _feed_jax_permutations(monkeypatch, key, num_epochs, n):
    """The port draws JAX's per-epoch permutations of this update."""
    _, *epoch_keys = jax.random.split(key, num_epochs + 1)
    perms = iter([torch.tensor(np.asarray(jax.random.permutation(k, n))) for k in epoch_keys])
    monkeypatch.setattr(ppo, "_permutation", lambda n, generator: next(perms))


def test_ppo_update_matches_jax(monkeypatch):
    """2 epochs x 4 minibatches of 64, JAX's permutations."""
    batch = _ppo_batch()
    init_j, update_j = jax_ppo._make_learner(_ppo_config(jax_ppo), 4, 2)
    state_j = _np(init_j(0))
    _, update = ppo._make_learner(_ppo_config(ppo), 4, 2, device="cpu")
    state = learner_state_from_numpy(state_j, device="cpu")
    _feed_jax_permutations(monkeypatch, jnp.asarray(state_j["key"]), 2, 256)
    state, metrics = update(state, batch)
    out_j, metrics_j = update_j(jax.tree_util.tree_map(jnp.asarray, state_j),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    out_j = _np(out_j)
    _assert_metrics_close(metrics, metrics_j)
    assert_tree_close(state["params"], out_j["params"], PARAM_ATOL)
    _assert_adam_close(state["opt_state"], out_j["opt_state"])
    assert state["opt_state"]["count"] == 8


def test_advantages_use_the_population_std():
    """jnp.std is ddof 0, torch.std ddof 1 by default: the port's
    standardisation is JAX's, and a ddof-1 one is visibly not."""
    adv = np.random.default_rng(0).normal(size=8).astype(np.float32)
    theirs = np.asarray((jnp.asarray(adv) - adv.mean()) / (jnp.asarray(adv).std() + 1e-8))
    ours = ppo.standardize(torch.as_tensor(adv)).numpy()
    assert_close_to_scale(ours, theirs)
    t = torch.as_tensor(adv)
    ddof1 = ((t - t.mean()) / (t.std() + 1e-8)).numpy()
    assert np.abs(ddof1 - theirs).max() > 100 * FWD_TOL


def _trajectory_batch(T=8, N=4, seed=1):
    rng = np.random.default_rng(seed)
    term = rng.random((T, N)) < 0.1
    return {
        "obs": rng.normal(size=(T, N, 4)).astype(np.float32),
        "next_obs": rng.normal(size=(T, N, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, size=(T, N)),
        "action_logp": (-0.69 + 0.3 * rng.normal(size=(T, N))).astype(np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32) + 1.0,
        "terminateds": term,
        "dones": term | (rng.random((T, N)) < 0.1),
    }


@pytest.mark.parametrize("algo", ["impala", "appo"])
def test_vtrace_learner_update_matches_jax(algo):
    if algo == "impala":
        cfg_j, cfg = jax_impala.IMPALAConfig(), IMPALAConfig()
        init_j, update_j = jax_impala.make_impala_learner(cfg_j, 4, 2)
        _, update = make_impala_learner(cfg, 4, 2, device="cpu")
    else:
        cfg_j, cfg = jax_appo.APPOConfig(), APPOConfig()
        init_j, update_j = jax_appo.make_appo_learner(cfg_j, 4, 2)
        _, update = make_appo_learner(cfg, 4, 2, device="cpu")
    batch = _trajectory_batch()
    state_j = _np(init_j(0))
    state, metrics = LearnerGroup(update, 1).update(
        learner_state_from_numpy(state_j, device="cpu"), batch)
    out_j, metrics_j = jax.jit(update_j)(state_j, {k: jnp.asarray(v) for k, v in batch.items()})
    _assert_metrics_close(metrics, metrics_j)
    out_j = _np(out_j)
    assert_tree_close(state["params"], out_j["params"], PARAM_ATOL)
    _assert_adam_close(state["opt_state"], out_j["opt_state"])


def test_dqn_update_many_and_sync_match_jax():
    cfg_j, cfg = jax_dqn.DQNConfig().training(lr=1e-3), DQNConfig().training(lr=1e-3)
    init_j, update_j, sync_j = jax_dqn._make_learner(cfg_j, 4, 2)
    _, update, sync = dqn._make_learner(cfg, 4, 2, device="cpu")
    rng = np.random.default_rng(4)
    U, B = 4, 32
    batches = (rng.normal(size=(U, B, 4)).astype(np.float32), rng.integers(0, 2, (U, B)),
               rng.normal(size=(U, B)).astype(np.float32),
               rng.normal(size=(U, B, 4)).astype(np.float32),
               (rng.random((U, B)) < 0.2).astype(np.float32))
    state_j = _np(init_j(0))
    # A target a few steps behind the online net, as between syncs.
    state_j["target"] = jax.tree_util.tree_map(
        lambda x: x + 0.05 * np.random.default_rng(5).normal(size=x.shape).astype(np.float32),
        state_j["target"])
    state = learner_state_from_numpy(state_j, device="cpu")
    state, loss = update(state, batches)
    out_j, loss_j = update_j(jax.tree_util.tree_map(jnp.asarray, state_j),
                             tuple(jnp.asarray(b) for b in batches))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=UPDATE_RTOL)
    out_j = _np(out_j)
    assert_tree_close(state["params"], out_j["params"], PARAM_ATOL)
    assert_tree_close(state["target"], out_j["target"], 0.0)  # untouched until the sync
    _assert_adam_close(state["opt_state"], out_j["opt_state"])
    state, out_j = sync(state), _np(sync_j(out_j))
    assert_tree_close(state["target"], out_j["target"], PARAM_ATOL)
    assert state["target"]["pi"]["w"].data_ptr() != state["params"]["pi"]["w"].data_ptr()


def test_sac_update_matches_jax(monkeypatch):
    """One Pendulum update with JAX's noise for the next actions and the
    actor's sample."""
    cfg_j = jax_sac.SACConfig().training(hidden=(32, 32))
    cfg = SACConfig().training(hidden=(32, 32))
    init_j, update_j = jax_sac.make_sac_learner(cfg_j, 3, 1)
    _, update = make_sac_learner(cfg, 3, 1, device="cpu")
    rng = np.random.default_rng(6)
    B = 64
    batch = {"obs": rng.normal(size=(B, 3)).astype(np.float32),
             "actions": rng.uniform(-2, 2, (B, 1)).astype(np.float32),
             "rewards": rng.normal(size=B).astype(np.float32) - 3.0,
             "next_obs": rng.normal(size=(B, 3)).astype(np.float32),
             "terminateds": (rng.random(B) < 0.1).astype(np.float32)}
    state_j = _np(init_j(0))
    state_j["log_alpha"] = np.float32(-0.3)  # alpha away from 1
    _, k_next, k_pi = jax.random.split(jnp.asarray(state_j["key"]), 3)
    noise = iter([torch.tensor(np.asarray(jax.random.normal(k, (B, 1)))) for k in (k_next, k_pi)])
    monkeypatch.setattr(sac, "_normal", lambda shape, generator: next(noise))
    state, metrics = update(learner_state_from_numpy(state_j, device="cpu"), batch)
    out_j, metrics_j = update_j(jax.tree_util.tree_map(jnp.asarray, state_j),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    _assert_metrics_close(metrics, metrics_j)
    out_j = _np(out_j)
    assert_tree_close(state["params"], out_j["params"], PARAM_ATOL)
    assert_tree_close(state["target"], out_j["target"], PARAM_ATOL)
    np.testing.assert_allclose(float(state["log_alpha"].detach()), float(out_j["log_alpha"]),
                               atol=PARAM_ATOL)
    for opt in ("pi_opt", "q_opt", "a_opt"):
        _assert_adam_close(state[opt], out_j[opt])


# -- a learning run -----------------------------------------------------------------


def test_ppo_cartpole_learns_in_process():
    """tests/test_rllib.py::test_ppo_cartpole_learns's configuration, its
    two runners in this process: the dataflow of PPO.train() without the
    actor hop. Best mean return of the last 100 episodes >= 120 within 100
    iterations."""
    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=2, num_envs_per_runner=8, rollout_length=64)
           .training(lr=1e-3, num_epochs=8, minibatch_size=128, entropy_coeff=0.005)
           .debugging(seed=7))
    runners = [EnvRunner(cfg.env, cfg.num_envs_per_runner, cfg.rollout_length, gamma=cfg.gamma,
                         lam=cfg.lam, seed=cfg.seed + 1000 * (i + 1), hidden=cfg.hidden,
                         device="cpu") for i in range(cfg.num_env_runners)]
    init_state, update = ppo._make_learner(cfg, 4, 2, device="cpu")
    state = init_state(cfg.seed)
    returns, best, t0 = [], 0.0, time.perf_counter()
    for it in range(100):
        results = [r.sample(state["params"]) for r in runners]
        batch = SampleBatch.concat_samples([SampleBatch(r["batch"]) for r in results])
        returns = (returns + [x for r in results for x in r["episode_returns"]])[-100:]
        state, metrics = update(state, {k: batch[k] for k in (OBS, ACTIONS, LOGPS, ADVANTAGES,
                                                             RETURNS)})
        assert np.isfinite(float(metrics["total_loss"]))
        best = max(best, float(np.mean(returns)) if returns else 0.0)
        if best >= 120.0:
            break
    print(f"PPO reached {best:.1f} in {it + 1} iterations, {time.perf_counter() - t0:.1f} s")
    assert best >= 120.0, f"PPO failed to learn: best={best:.1f}"


# -- what is not ported yet, and where the entry points run ----------------------


@pytest.mark.parametrize("config", [PPOConfig, IMPALAConfig, APPOConfig, DQNConfig, SACConfig,
                                    MultiAgentPPOConfig])
def test_algorithm_classes_are_not_ported_yet(config):
    """The algorithm classes drive their runners as ray_tpu actors: build()
    raises, naming the runtime copy they wait for."""
    with pytest.raises(NotImplementedError, match="A14"):
        config().build()


@pytest.mark.parametrize("make", [
    lambda: TorchPolicy(4, 2),
    lambda: EnvRunner("CartPole-v1", 2, 4),
    lambda: ppo._make_learner(PPOConfig(), 4, 2),
    lambda: make_impala_learner(IMPALAConfig(), 4, 2),
    lambda: dqn._make_learner(DQNConfig(), 4, 2),
    lambda: dqn._DQNRunner("CartPole-v1", 2, 0),
    lambda: make_sac_learner(SACConfig(), 3, 1),
    lambda: sac._SACRunner("Pendulum-v1", 2, 0, (32,), 2.0),
    lambda: MultiAgentEnvRunner(MultiAgentCartPole, 2, 4, {"agent_0": "p", "agent_1": "p"}),
    lambda: make_policy_learners(MultiAgentPPOConfig().environment(MultiAgentCartPole)
                                 .multi_agent({"agent_0": "p", "agent_1": "p"})),
], ids=["policy", "env_runner", "ppo", "impala", "dqn", "dqn_runner", "sac", "sac_runner",
        "multi_agent_runner", "multi_agent_learners"])
def test_entry_points_run_on_the_card_unless_asked(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_learner_group_needs_a_rank_per_learner():
    _, update = make_impala_learner(IMPALAConfig(), 4, 2, device="cpu")
    with pytest.raises(ValueError, match="num_learners=2 > ranks"):
        LearnerGroup(update, 2)
