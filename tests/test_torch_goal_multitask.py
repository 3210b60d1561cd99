"""The port's goal-conditioned and multitask data, envs and collectors
against the JAX package's, on the CPU, bit for bit with the same
``RandomState``s: the in-memory loaders and conv size calculators, the HER
buffer (future relabelling, the clip, env or default rewards), the
multitask and split buffers and the meta-RL loop's draw order, the frame
and state stacks and ``make``, the extra wrappers, the dict-observation
image envs, the task envs (on cheetah-run where dm_control is present, as
the JAX test runs them) and the obs-dict, goal-conditioned and in-place
collectors. Last, the path ``chip_smoke.py`` drives on the card (phase 24),
at a tiny width on the CPU: goal-conditioned collection into the HER
buffer, SAC on its relabelled batches, the meta-RL loop over SAC."""

import numpy as np
import pytest
import torch

import s2p_tpu.data.her_buffer as jher
import s2p_tpu.data.loaders as jloaders
import s2p_tpu.data.multitask_buffer as jmt
import s2p_tpu.envs as jenvs
import s2p_tpu.envs.multitask as jtasks
import s2p_tpu.samplers as jsamplers
from s2p_tpu.data.replay import SimpleReplayBuffer as JaxSimpleReplayBuffer
import s2p_tpu_torch.data as data
import s2p_tpu_torch.data.loaders as loaders
import s2p_tpu_torch.envs as envs
import s2p_tpu_torch.envs.multitask as tasks
import s2p_tpu_torch.samplers as samplers
from s2p_tpu_torch.rl import CriticSLAC, SACTrainer, TanhGaussianPolicy
from s2p_tpu_torch.testing.goal_env import PointRobotGoalEnv, TaskBatchTrainer


def assert_trees_equal(got, ref):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert_trees_equal(got[k], ref[k])
    elif isinstance(ref, (list, tuple)) or getattr(ref, "dtype", None) == object:
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_trees_equal(g, r)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.fixture
def dmc():
    return pytest.importorskip("dm_control", reason="dm_control missing")


# -- loaders -----------------------------------------------------------------------


@pytest.mark.parametrize("n,batch,seed", [(10, 3, 0), (17, 4, 5), (8, 8, 1)])
def test_infinite_random_sampler_matches_jax(n, batch, seed):
    got, ref = loaders.infinite_random_sampler(n, batch, seed), jloaders.infinite_random_sampler(
        n, batch, seed)
    for _ in range(12):
        np.testing.assert_array_equal(next(got), next(ref))
    ds = {"x": np.arange(2 * n).reshape(n, 2), "y": np.arange(n)}
    it, jit = loaders.batch_iterator(ds, batch, seed), jloaders.batch_iterator(ds, batch, seed)
    for _ in range(5):
        assert_trees_equal(next(it), next(jit))


def test_image_dataset_and_conv_size_calculators_match_jax():
    imgs = np.arange(24).reshape(4, 2, 3)
    labels = np.arange(4) * 10
    for args in ((imgs,), (imgs, labels)):
        got, ref = loaders.ImageDataset(*args), jloaders.ImageDataset(*args)
        assert len(got) == len(ref) == 4
        assert_trees_equal(got[2], ref[2])
    for h in (7, 32, 84, 100):
        for k, s, p, d in ((3, 1, 0, 1), (3, 2, 1, 1), (5, 2, 0, 2), (4, 3, 2, 1)):
            assert loaders.conv2d_output_size(h, k, s, p, d) == jloaders.conv2d_output_size(
                h, k, s, p, d)
            assert (loaders.conv_transpose2d_output_size(h, k, s, p, 1, d)
                    == jloaders.conv_transpose2d_output_size(h, k, s, p, 1, d))
        stack = ([3, 3, 5], [2, 1, 1], [0, 1, 2])
        assert loaders.conv_stack_output_shape(h, *stack) == jloaders.conv_stack_output_shape(
            h, *stack)


# -- HER ---------------------------------------------------------------------------


class _GoalEnv:
    def compute_rewards(self, achieved, goals):
        return -(np.linalg.norm(achieved - goals, axis=1) > 0.5).astype(np.float32)

    def sample_goals(self, n):
        return np.full((n, 2), 0.25, np.float32)


def goal_path(T, seed):
    rs = np.random.RandomState(seed)
    obs = [dict(observation=rs.randn(3).astype(np.float32),
                desired_goal=rs.randn(2).astype(np.float32),
                achieved_goal=rs.randn(2).astype(np.float32)) for _ in range(T + 1)]
    return dict(observations=obs[:-1], next_observations=obs[1:],
                actions=rs.randn(T, 2).astype(np.float32),
                terminals=(rs.rand(T) < 0.1).astype(np.float32))


@pytest.mark.parametrize("env,rollout,env_goals", [
    (_GoalEnv(), 0.0, 0.0),       # every goal a future achieved goal, the env's rewards
    (_GoalEnv(), 0.25, 0.25),     # rollout, env-sampled and future goals
    (object(), 0.2, 0.0),         # the default sparse reward
    (PointRobotGoalEnv(), 0.5, 0.0),
])
def test_her_buffer_batches_match_jax(env, rollout, env_goals):
    kw = dict(fraction_goals_rollout_goals=rollout, fraction_goals_env_goals=env_goals)
    got, ref = data.ObsDictRelabelingBuffer(60, env, **kw), jher.ObsDictRelabelingBuffer(60, env,
                                                                                          **kw)
    for i, T in enumerate((5, 9, 3, 7)):
        path = goal_path(T, i)
        got.add_path(path)
        ref.add_path(path)
    assert len(got) == len(ref) == 24
    np.testing.assert_array_equal(got._path_end, ref._path_end)
    for seed in range(3):
        assert_trees_equal(got.random_batch(40, np.random.RandomState(seed)),
                           ref.random_batch(40, np.random.RandomState(seed)))
    assert got.get_diagnostics() == ref.get_diagnostics()


def test_her_buffer_refuses_a_path_past_its_end():
    """JAX's assert is a ValueError in the port; neither stores the path."""
    got, ref = data.ObsDictRelabelingBuffer(8, _GoalEnv()), jher.ObsDictRelabelingBuffer(
        8, _GoalEnv())
    for buf in (got, ref):
        buf.add_path(goal_path(5, 0))
    with pytest.raises(ValueError):
        got.add_path(goal_path(4, 1))
    with pytest.raises(AssertionError):
        ref.add_path(goal_path(4, 1))
    assert len(got) == len(ref) == 5


def test_her_future_goals_are_clipped_to_the_filled_rows():
    """A path's end past the filled rows (``_path_end`` of a path that was
    cut) is clipped to the last filled row, in both packages."""
    got, ref = data.ObsDictRelabelingBuffer(20, _GoalEnv(), 0.0), jher.ObsDictRelabelingBuffer(
        20, _GoalEnv(), 0.0)
    for buf in (got, ref):
        buf.add_path(goal_path(6, 3))
        buf._path_end[:] = 50
    assert_trees_equal(got.random_batch(64, np.random.RandomState(4)),
                       ref.random_batch(64, np.random.RandomState(4)))


# -- multitask buffers and the meta loop -------------------------------------------


def test_multitask_and_split_buffers_match_jax():
    env = envs.StubEnv(obs_dim=3, action_dim=2)
    got = data.MultiTaskReplayBuffer(50, env, [0, 1, 4], device="cpu")
    ref = jmt.MultiTaskReplayBuffer(50, env, [0, 1, 4])
    rs = np.random.RandomState(0)
    for t in (0, 1, 4):
        for _ in range(7 + t):
            row = (rs.randn(3), rs.randn(2), rs.randn(), float(rs.rand() < 0.2), rs.randn(3))
            got.add_sample(t, *row)
            ref.add_sample(t, *row)
    assert [got.num_steps_can_sample(t) for t in (0, 1, 4)] == [
        ref.num_steps_can_sample(t) for t in (0, 1, 4)]
    assert_trees_equal(got.random_batch(4, 5, np.random.RandomState(1)),
                       ref.random_batch(4, 5, np.random.RandomState(1)))
    assert_trees_equal(got.sample_tasks_batch([1, 0, 4, 1], 6, np.random.RandomState(2)),
                       ref.sample_tasks_batch([1, 0, 4, 1], 6, np.random.RandomState(2)))

    split = data.SplitReplayBuffer(data.SimpleReplayBuffer(80, 3, 2, device="cpu"),
                                   data.SimpleReplayBuffer(80, 3, 2, device="cpu"), 0.6, seed=3)
    jsplit = jmt.SplitReplayBuffer(JaxSimpleReplayBuffer(80, 3, 2), JaxSimpleReplayBuffer(80, 3, 2),
                                   0.6, seed=3)
    for i in range(12):
        prs = np.random.RandomState(10 + i)
        path = dict(observations=prs.randn(4, 3), actions=prs.randn(4, 2), rewards=prs.rand(4),
                    terminals=np.zeros(4), next_observations=prs.randn(4, 3))
        split.add_path(path)
        jsplit.add_path(path)
    assert len(split) == len(jsplit) > 0
    assert len(split.validation_replay_buffer) == len(jsplit.validation_replay_buffer) > 0
    assert_trees_equal(split.random_batch(8, rng=np.random.RandomState(5)),
                       jsplit.random_batch(8, rng=np.random.RandomState(5)))


class _Recorder:
    def __init__(self):
        self.batches, self.epochs = [], []

    def train(self, batch):
        self.batches.append(batch)

    def end_epoch(self, epoch):
        self.epochs.append(epoch)


def test_meta_rl_loop_draws_as_jax_does():
    """The same tasks, paths and batches, in the same order, from the same
    seed: the loop's ``RandomState`` chooses the tasks of an iteration, then
    those of each meta-batch, and samples the batches."""
    runs = []
    for env_mod, buf_mod, kw in ((tasks, data, dict(device="cpu")), (jtasks, jmt, {})):
        env = env_mod.PointRobotEnv(num_tasks=5, max_episode_steps=4, seed=1)
        buf = buf_mod.MultiTaskReplayBuffer(100, env, env.get_all_task_idx(), **kw)
        seen, rec = [], _Recorder()

        def collect(task, env=env, seen=seen):
            seen.append((task, env._task["goal"].copy()))
            rs = np.random.RandomState(task)
            return [dict(observations=rs.randn(4, 2), actions=rs.randn(4, 2), rewards=rs.rand(4),
                         terminals=np.zeros(4), next_observations=rs.randn(4, 2))]

        algo = buf_mod.MetaRLAlgorithm(env, rec, buf, collect, env.get_all_task_idx(),
                                       num_iterations=3, num_tasks_per_itr=5,
                                       num_train_steps_per_itr=2, meta_batch=2, batch_size=3,
                                       seed=7)
        algo.train()
        runs.append((seen, rec.batches, rec.epochs))
    assert_trees_equal(runs[0], runs[1])
    assert len(runs[0][1]) == 6 and runs[0][1][0]["observations"].shape == (2, 3, 2)


# -- envs --------------------------------------------------------------------------


def step_both(got_env, ref_env, actions):
    assert_trees_equal(got_env.reset(), ref_env.reset())
    for a in actions:
        g, r = got_env.step(a), ref_env.step(a)
        assert_trees_equal(g[0], r[0])
        assert g[1:3] == r[1:3]


def test_frame_and_state_stacks_match_jax():
    img = dict(image_shape=(6, 6, 3), action_dim=2, max_episode_steps=5)
    got, ref = envs.FrameStack(envs.StubEnv(**img), 3), jenvs.FrameStack(jenvs.StubEnv(**img), 3)
    assert got.observation_space.shape == ref.observation_space.shape == (6, 6, 9)
    step_both(got, ref, [np.zeros(2)] * 4)
    state = dict(obs_dim=17, action_dim=6)
    got = envs.StateStack(envs.StubEnv(**state), 2, env_id="cheetah-run")
    ref = jenvs.StateStack(jenvs.StubEnv(**state), 2, env_id="cheetah-run")
    assert got.qpos_idx == ref.qpos_idx == 8
    assert got.observation_space.shape == ref.observation_space.shape == (16,)
    step_both(got, ref, [np.zeros(6)] * 3)
    with pytest.raises(ValueError):
        envs.StateStack(envs.StubEnv(**state), 2, env_id="walker-walk")
    with pytest.raises(AssertionError):
        jenvs.StateStack(jenvs.StubEnv(**state), 2, env_id="walker-walk")


def test_make_matches_jax_with_a_custom_class():
    kw = dict(env_class=envs.StubEnv, env_kwargs=dict(image_shape=(4, 4, 3), action_dim=2))
    got = envs.make(frame_stack=2, **kw)
    ref = jenvs.make(frame_stack=2, **dict(kw, env_class=jenvs.StubEnv))
    assert isinstance(got, envs.NormalizedBoxEnv) and isinstance(got._wrapped_env,
                                                                  envs.FrameStack)
    step_both(got, ref, [np.full(2, 0.5)] * 3)
    assert not isinstance(envs.make(normalize_env=False, **kw), envs.NormalizedBoxEnv)


def test_make_matches_jax_on_dmc(dmc):
    """A registry id, and an unknown task of a known domain (resolved to
    the domain's registered task), with a state stack."""
    kw = dict(env_kwargs=dict(seed=3), state_stack=2)
    got, ref = envs.make("cheetah-run", **kw), jenvs.make("cheetah-run", **kw)
    rs = np.random.RandomState(0)
    step_both(got, ref, [rs.uniform(-1, 1, 6) for _ in range(3)])
    fuzzy = envs.make("cheetah-sprint", env_kwargs=dict(seed=0), normalize_env=False)
    assert fuzzy.observation_space.shape == (17,)


def test_extra_wrappers_match_jax():
    base = dict(obs_dim=3, action_dim=2, max_episode_steps=6)
    pairs = [
        (envs.HistoryEnv(envs.StubEnv(**base), 3), jenvs.HistoryEnv(jenvs.StubEnv(**base), 3)),
        (envs.RewardWrapperEnv(envs.StubEnv(**base), lambda r, info: 2 * r - 1),
         jenvs.RewardWrapperEnv(jenvs.StubEnv(**base), lambda r, info: 2 * r - 1)),
        (envs.StackObservationEnv(envs.StubEnv(**base), 4),
         jenvs.StackObservationEnv(jenvs.StubEnv(**base), 4)),
    ]
    for got, ref in pairs:
        assert got.observation_space.shape == ref.observation_space.shape
        step_both(got, ref, [np.full(2, 0.3)] * 3)
    assert pairs[0][0].reset().shape == (9,)

    got = envs.DiscretizeEnv(envs.StubEnv(**base), 3)
    ref = jenvs.DiscretizeEnv(jenvs.StubEnv(**base), 3)
    assert got.n == ref.n == 9
    assert_trees_equal(got.idx_to_continuous_action, ref.idx_to_continuous_action)
    np.random.seed(0)  # DiscretizeEnv's sample draws from the global np.random
    drawn = [got.action_space.sample() for _ in range(5)]
    np.random.seed(0)
    assert drawn == [ref.action_space.sample() for _ in range(5)]
    step_both(got, ref, drawn)


def test_image_envs_match_jax():
    base = dict(obs_dim=3, action_dim=2, max_episode_steps=4)
    step_both(envs.GymToMultiEnv(envs.StubEnv(**base)),
              jenvs.GymToMultiEnv(jenvs.StubEnv(**base)), [np.zeros(2)] * 2)
    for normalize in (True, False):
        got = envs.ImageEnv(envs.StubEnv(**base), imsize=8, normalize=normalize)
        ref = jenvs.ImageEnv(jenvs.StubEnv(**base), imsize=8, normalize=normalize)
        assert got.observation_space.dtype == ref.observation_space.dtype
        step_both(got, ref, [np.zeros(2)] * 3)
    o = envs.ImageEnv(envs.StubEnv(**base), imsize=8).reset()
    assert o["image_observation"].dtype == np.float32 and o["image_observation"].max() <= 1.0


def test_mujoco_gym_to_multi_env_state_replay_matches_jax(dmc):
    got = envs.MujocoGymToMultiEnv(envs.make_dmc("cheetah-run", seed=0))
    ref = jenvs.MujocoGymToMultiEnv(jenvs.make_dmc("cheetah-run", seed=0))
    step_both(got, ref, [np.full(6, 0.2)] * 3)
    qpos, qvel = got.get_state()
    assert_trees_equal((qpos, qvel), ref.get_state())
    rs = np.random.RandomState(1)
    q, v = rs.randn(*qpos.shape) * 0.1, rs.randn(*qvel.shape) * 0.1
    got.set_state(q, v)
    ref.set_state(q, v)
    assert_trees_equal(got.get_state(), ref.get_state())
    np.testing.assert_array_equal(got.get_state()[0], q)


def test_point_robot_tasks_match_jax():
    got, ref = tasks.PointRobotEnv(num_tasks=4, seed=2), jtasks.PointRobotEnv(num_tasks=4, seed=2)
    assert_trees_equal(got.tasks, ref.tasks)
    assert got.get_all_task_idx() == ref.get_all_task_idx() == [0, 1, 2, 3]
    assert_trees_equal(got.sample_tasks(3, seed=5), ref.sample_tasks(3, seed=5))
    assert_trees_equal(got.reset_task(2), ref.reset_task(2))
    rs = np.random.RandomState(0)
    for _ in range(got.max_episode_steps):
        a = rs.uniform(-0.3, 0.3, 2)
        g, r = got.step(a), ref.step(a)
        assert_trees_equal(g, r)
    assert g[2] and g[3]["TimeLimit.truncated"]


def test_dmc_task_envs_match_jax(dmc):
    """Velocity, direction and rand-param tasks over cheetah-run, including
    JAX's quirks: ``VelocityTaskEnv.sample_tasks`` draws from [0, 3)
    whatever ``max_vel`` is."""
    mk = lambda pkg: pkg.make_dmc("cheetah-run", seed=0)  # noqa: E731
    got, ref = tasks.VelocityTaskEnv(mk(envs), 3, max_vel=1.0), jtasks.VelocityTaskEnv(
        mk(jenvs), 3, max_vel=1.0)
    assert_trees_equal(got.tasks, ref.tasks)
    sampled = got.sample_tasks(20, seed=1)
    assert_trees_equal(sampled, ref.sample_tasks(20, seed=1))
    assert max(t["velocity"] for t in sampled) > 1.0
    rs = np.random.RandomState(2)
    actions = [rs.uniform(-1, 1, 6) for _ in range(3)]
    for g_env, r_env in ((got, ref),
                         (tasks.DirectionTaskEnv(mk(envs)), jtasks.DirectionTaskEnv(mk(jenvs))),
                         (tasks.RandParamEnv(mk(envs), 3), jtasks.RandParamEnv(mk(jenvs), 3))):
        assert_trees_equal(g_env.tasks, r_env.tasks)
        assert_trees_equal(g_env.reset_task(1), r_env.reset_task(1))
        for a in actions:
            g, r = g_env.step(a), r_env.step(a)
            assert_trees_equal(g[0], r[0])
            assert g[1:3] == r[1:3] and g[3] == r[3]
    np.testing.assert_array_equal(got.physics.model.body_mass, ref.physics.model.body_mass)


# -- collectors --------------------------------------------------------------------


def seeded_agent(pkg, env, seed):
    env.action_space.seed(seed)
    return pkg.RandomAgent(env.action_space)


def strip(paths):
    keys = ("observations", "actions", "rewards", "next_observations", "terminals", "dones")
    return [{k: p[k] for k in keys} for p in paths]


def test_obs_dict_and_goal_collectors_match_jax():
    kw = dict(obs_dim=3, action_dim=2, max_episode_steps=4)
    got_env, ref_env = envs.GymToMultiEnv(envs.StubEnv(**kw)), jenvs.GymToMultiEnv(
        jenvs.StubEnv(**kw))
    got = samplers.ObsDictPathCollector(got_env, seeded_agent(samplers, got_env, 0))
    ref = jsamplers.ObsDictPathCollector(ref_env, seeded_agent(jsamplers, ref_env, 0))
    assert_trees_equal(strip(got.collect_new_paths(4, 10, False)),
                       strip(ref.collect_new_paths(4, 10, False)))
    assert got.get_snapshot()["observation_key"] == "observation"

    seen = []

    class _Agent(samplers.RandomAgent):
        def get_action(self, obs):
            seen.append(obs)
            return super().get_action(obs)

    g_env, r_env = PointRobotGoalEnv(4, 5, seed=1), PointRobotGoalEnv(4, 5, seed=1)
    g_env.action_space.seed(2)
    r_env.action_space.seed(2)
    got = samplers.GoalConditionedPathCollector(g_env, _Agent(g_env.action_space))
    ref = jsamplers.GoalConditionedPathCollector(r_env, jsamplers.RandomAgent(r_env.action_space))
    paths = got.collect_new_paths(5, 12, True)
    assert_trees_equal(strip(paths), strip(ref.collect_new_paths(5, 12, True)))
    assert seen[0].shape == (4,)  # position 2 + goal 2
    np.testing.assert_array_equal(seen[0][2:], g_env.tasks[0]["goal"])
    snap = got.get_snapshot()
    assert (snap["observation_key"], snap["desired_goal_key"]) == ("observation", "desired_goal")


def test_in_place_sampler_matches_jax():
    kw = dict(obs_dim=3, action_dim=2, max_episode_steps=4)
    got_env, ref_env = envs.StubEnv(**kw), jenvs.StubEnv(**kw)
    got = samplers.InPlacePathSampler(got_env, seeded_agent(samplers, got_env, 1), 4)
    ref = jsamplers.InPlacePathSampler(ref_env, seeded_agent(jsamplers, ref_env, 1), 4)
    for max_samples, max_trajs in ((10, None), (100, 2)):
        (gp, gn), (rp, rn) = (got.obtain_samples(max_samples, max_trajs),
                              ref.obtain_samples(max_samples, max_trajs))
        assert gn == rn and len(gp) == len(rp)
        assert_trees_equal(strip(gp), strip(rp))


# -- the goal-conditioned and multitask path (chip_smoke.py phase 24, tiny) --------


def test_goal_and_multitask_path_on_sac():
    """Goal-conditioned collection with a port policy fills the HER buffer;
    SAC trains on its relabelled batches; the meta-RL loop runs SAC on the
    multitask buffer's flattened [tasks, batch] batches. Finite metrics, the
    expected shapes and counts."""
    env = PointRobotGoalEnv(num_tasks=4, max_episode_steps=6, seed=0)
    policy = TanhGaussianPolicy(4, (8,), 2, seed=0)
    sac = SACTrainer(policy, CriticSLAC(4, 2, (8,), seed=1), seed=0, device="cpu")
    col = samplers.GoalConditionedPathCollector(env, samplers.PolicyAgent(policy, seed=0))
    her = data.ObsDictRelabelingBuffer(100, env, fraction_goals_rollout_goals=0.2)
    for p in col.collect_new_paths(6, 24, discard_incomplete_paths=False):
        her.add_path(p)
    assert len(her) == 24
    batch = her.random_batch(16, np.random.RandomState(0))
    assert batch["observations"].shape == (16, 4) and (batch["rewards"] <= 0).all()
    metrics = sac.train(batch)
    assert all(torch.isfinite(v).all() for v in metrics.values())

    point = tasks.PointRobotEnv(num_tasks=4, max_episode_steps=6, seed=0)
    flat_policy = TanhGaussianPolicy(2, (8,), 2, seed=2)
    mt_sac = SACTrainer(flat_policy, CriticSLAC(2, 2, (8,), seed=3), seed=1, device="cpu")
    mtb = data.MultiTaskReplayBuffer(200, point, point.get_all_task_idx(), device="cpu")
    collector = samplers.MdpPathCollector(point, samplers.PolicyAgent(flat_policy, seed=1))
    trainer = TaskBatchTrainer(mt_sac)
    algo = data.MetaRLAlgorithm(point, trainer, mtb,
                                lambda task: collector.collect_new_paths(6, 12, False),
                                point.get_all_task_idx(), num_iterations=2, num_tasks_per_itr=4,
                                num_train_steps_per_itr=3, meta_batch=2, batch_size=8)
    algo.train()
    assert trainer.n_train_calls == 6 and mt_sac._n_train_steps_total == 6
    assert sum(mtb.num_steps_can_sample(t) for t in point.get_all_task_idx()) == 2 * 4 * 12
    assert np.isfinite(list(mt_sac.get_diagnostics().values())).all()
