"""The port's replay buffers (s2p_tpu_torch.data.replay) and samplers
(s2p_tpu_torch.rl.scan_utils) against the JAX package's.

Ingestion is host numpy in both packages: every array must be equal. The
gather at given indices must give the same floats (uint8 / 255 as a true
division on both sides)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.data.hdf5 import SENTINEL, make_slac_window_indices, make_synthetic_rl_dataset
from s2p_tpu.data.replay import SimpleReplayBuffer as JaxSimpleReplayBuffer
from s2p_tpu.data.replay import SlacReplayBuffer as JaxSlacReplayBuffer
from s2p_tpu.data.replay import _gather_windows
from s2p_tpu_torch.data.replay import SimpleReplayBuffer, SlacReplayBuffer
from s2p_tpu_torch.rl.scan_utils import make_flat_sampler, make_window_sampler

NS, ACT, HW = 4, 3, 8
UNCERTAINTY = [None, "aleatoric", "disagreement", "max_of_both", "min_of_both", "average_both"]


def buffers(capacity=500):
    args = (capacity, NS, (HW, HW, 3), ACT)
    return JaxSlacReplayBuffer(*args), SlacReplayBuffer(*args, device="cpu")


def assert_same_arrays(jbuf, buf):
    assert len(jbuf) == len(buf) and jbuf.real_n == buf.real_n
    for name in ("_windows", "_actions", "_rewards", "_dones"):
        np.testing.assert_array_equal(getattr(buf, name), getattr(jbuf, name), err_msg=name)
    np.testing.assert_array_equal(buf._frames[:buf._n_frames], jbuf._frames[:jbuf._n_frames])
    js, st = jbuf.device_state(), buf.device_state()
    for k in ("frames", "windows", "actions", "rewards", "dones"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(js[k]), err_msg=k)
    assert st["n"] == int(js["n"])


def augment_dataset(n_eps=3, ep_len=12, seed=0):
    """An augment-schema dataset (window indices with sentinels, both
    uncertainties, original columns), as the world model writes it."""
    rs = np.random.RandomState(seed)
    n = n_eps * ep_len
    ds = make_synthetic_rl_dataset(n_eps, ep_len, act_dim=ACT, img_hw=HW, seed=seed)
    obs_idx, act_idx = zip(*(make_slac_window_indices(ep_len, e * ep_len, NS)
                             for e in range(n_eps)))
    ds.update(original_actions=ds["actions"].copy(), original_rewards=ds["rewards"].copy(),
              actions=rs.uniform(-1, 1, (n, ACT)).astype(np.float32),
              rewards=rs.randn(n).astype(np.float32),
              slac_observation_indices=np.concatenate(obs_idx),
              slac_action_indices=np.concatenate(act_idx),
              aleatoric_uncertainty=rs.rand(n, 1).astype(np.float32),
              disagreement_uncertainty=rs.rand(n, 1).astype(np.float32))
    return ds


@pytest.mark.parametrize("n_eps,ep_len,tail", [(3, 10, 0), (2, 15, 6), (2, 10, 2)])
def test_ingest_real_equals_jax(n_eps, ep_len, tail):
    """Episodes by timeout, a trailing partial episode, the final timeout
    row dropped, episodes shorter than ``num_sequences`` skipped."""
    ds = make_synthetic_rl_dataset(n_eps + (tail > 0), ep_len, act_dim=ACT, img_hw=HW)
    if tail:
        cut = n_eps * ep_len + tail
        ds = {k: v[:cut] for k, v in ds.items()}
    jbuf, buf = buffers()
    assert jbuf.ingest_real(ds) == buf.ingest_real(ds)
    jbuf.mark_real()
    buf.mark_real()
    assert_same_arrays(jbuf, buf)


@pytest.mark.parametrize("utype", UNCERTAINTY)
def test_ingest_generated_equals_jax(utype):
    """Sentinel rows skipped, the trailing timeout row dropped, rewards
    penalized by λ × the chosen uncertainty, after real data."""
    ds = augment_dataset()
    jbuf, buf = buffers()
    real = make_synthetic_rl_dataset(2, 10, act_dim=ACT, img_hw=HW, seed=3)
    for b in (jbuf, buf):
        b.ingest_real(real)
        b.mark_real()
    lam = None if utype is None else 2.0
    added = buf.ingest_generated(ds, utype, lam)
    assert added == jbuf.ingest_generated(ds, utype, lam)
    valid = ~(ds["slac_observation_indices"] >= SENTINEL).any(axis=1)
    assert added == valid.sum() - 1  # the final row is a timeout row
    assert_same_arrays(jbuf, buf)


def test_ingest_generated_frames_override_and_bad_input():
    ds = augment_dataset(seed=1)
    frames = np.random.RandomState(2).randint(0, 256, ds["image_observations"].shape,
                                              dtype=np.uint8)
    jbuf, buf = buffers()
    assert (buf.ingest_generated(ds, "aleatoric", 2.0, generated_frames=frames)
            == jbuf.ingest_generated(ds, "aleatoric", 2.0, generated_frames=frames))
    assert_same_arrays(jbuf, buf)
    gen_slot = buf._windows[0, -1]
    np.testing.assert_array_equal(buf._frames[gen_slot], frames[NS - 1])  # row i−1's frame
    n = len(buf)
    with pytest.raises(NotImplementedError):
        buf.ingest_generated(ds, "bogus", 1.0)
    with pytest.raises(ValueError):
        buf.ingest_generated(ds, "aleatoric", None)
    assert len(buf) == n and buf._n_frames == jbuf._n_frames  # left as it was
    bad = dict(ds, slac_observation_indices=ds["slac_observation_indices"].copy())
    bad["slac_observation_indices"][NS, 0] = SENTINEL
    with pytest.raises(ValueError, match="partial sentinel"):
        buf.ingest_generated(bad)


def test_online_append_equals_jax():
    rs = np.random.RandomState(4)
    jbuf, buf = buffers()
    for ep_len in (7, 3, 6):
        first = rs.randint(0, 256, (HW, HW, 3), dtype=np.uint8)
        for b in (jbuf, buf):
            b.reset_episode(first)
        for t in range(ep_len):
            step = (rs.uniform(-1, 1, ACT).astype(np.float32), float(rs.randn()),
                    bool(rs.rand() < 0.2), rs.randint(0, 256, (HW, HW, 3), dtype=np.uint8),
                    t == ep_len - 1)
            for b in (jbuf, buf):
                b.append(*step)
    assert_same_arrays(jbuf, buf)
    with pytest.raises(RuntimeError):
        buf.append(*step)


def test_gather_at_given_indices_equals_jax():
    ds = make_synthetic_rl_dataset(2, 12, act_dim=ACT, img_hw=HW)
    jbuf, buf = buffers()
    jbuf.ingest_real(ds)
    buf.ingest_real(ds)
    idx = np.array([0, 5, len(buf) - 1, 3, 3])
    js = jbuf.device_state()
    ref = _gather_windows(js["frames"], js["windows"], js["actions"], js["rewards"],
                          js["dones"], jnp.asarray(idx))
    got = buf.gather(torch.from_numpy(idx))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].shape == (5, NS + 1, HW, HW, 3)


def test_device_state_is_cached_until_the_next_ingest():
    _, buf = buffers()
    buf.ingest_real(make_synthetic_rl_dataset(1, 10, act_dim=ACT, img_hw=HW))
    st = buf.device_state()
    assert buf.device_state() is st
    buf.ingest_real(make_synthetic_rl_dataset(1, 10, act_dim=ACT, img_hw=HW, seed=1))
    assert buf.device_state() is not st and buf.device_state()["n"] == len(buf)
    with pytest.raises(ValueError, match="empty"):
        buffers()[1].device_state()
    with pytest.raises(ValueError, match="overflow"):
        SlacReplayBuffer(3, NS, (HW, HW, 3), ACT, device="cpu").ingest_real(
            make_synthetic_rl_dataset(1, 10, act_dim=ACT, img_hw=HW))


def test_real_gen_split_ranges_and_samplers():
    """``random_batch_real_gen`` draws real slots below ``real_n`` and
    generated ones above; the window sampler's batch is half each buffer."""
    jbuf, buf = buffers()
    real = make_synthetic_rl_dataset(2, 10, act_dim=ACT, img_hw=HW)
    buf.ingest_real(real)
    buf.mark_real()
    gen = SlacReplayBuffer(500, NS, (HW, HW, 3), ACT, device="cpu")
    gen.ingest_generated(augment_dataset(seed=5), "disagreement", 1.0)
    buf.ingest_generated(augment_dataset(seed=5), "disagreement", 1.0)
    g = torch.Generator().manual_seed(0)
    r_batch, g_batch = buf.random_batch_real_gen(64, g)
    real_obs = {o.numpy().tobytes() for o in buf.gather(torch.arange(buf.real_n))[0]}
    assert all(o.numpy().tobytes() in real_obs for o in r_batch["observations"])
    assert not any(o.numpy().tobytes() in real_obs for o in g_batch["observations"])
    assert r_batch["rewards"].shape == (64, 1) and g_batch["terminals"].shape == (64, 1)

    sample = make_window_sampler(buf.device_state(), 9, g, gen.device_state())
    batch = sample()
    assert batch["observations"].shape == (9, NS + 1, HW, HW, 3)
    gen_obs = {o.numpy().tobytes() for o in gen.gather(torch.arange(len(gen)))[0]}
    assert sum(o.numpy().tobytes() in gen_obs for o in batch["observations"]) >= 5
    one = make_window_sampler(buf.device_state(), 4, torch.Generator().manual_seed(1))()
    assert one["actions"].shape == (4, NS, ACT) and one["rewards"].shape == (4, 1)


def test_simple_replay_buffer_equals_jax_and_flat_sampler():
    """The ring overwrite, the memory-efficient frame-stack rebuild, host
    batches from one RandomState, and the device state."""
    rs = np.random.RandomState(6)
    for image, efficient in ((False, False), (True, True)):
        shape = (HW, HW, 9) if image else 5
        jb = JaxSimpleReplayBuffer(10, shape, ACT, image_buffer=image,
                                   memory_efficient_way=efficient)
        b = SimpleReplayBuffer(10, shape, ACT, image_buffer=image,
                               memory_efficient_way=efficient, device="cpu")
        for _ in range(13):
            if image:
                o, no = (rs.randint(0, 256, (HW, HW, 9), dtype=np.uint8) for _ in range(2))
            else:
                o, no = rs.randn(5).astype(np.float32), rs.randn(5).astype(np.float32)
            sample = (o, rs.randn(ACT), float(rs.randn()), 0.0, no)
            jb.add_sample(*sample)
            b.add_sample(*sample)
        assert len(b) == len(jb) == 10
        ref = jb.random_batch(6, np.random.RandomState(7))
        got = b.random_batch(6, np.random.RandomState(7))
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    st = b_state = SimpleReplayBuffer(10, 5, ACT, device="cpu")
    for _ in range(4):
        st.add_sample(rs.randn(5), rs.randn(ACT), 1.0, 0.0, rs.randn(5))
    flat = make_flat_sampler(b_state.device_state(), 7, torch.Generator().manual_seed(2))()
    assert flat["observations"].shape == (7, 5) and flat["next_observations"].shape == (7, 5)
    with pytest.raises(ValueError):
        b.device_state()  # memory-efficient image mode
    js = JaxSimpleReplayBuffer(10, 5, ACT)
    js.add_sample(np.ones(5), np.ones(ACT), 1.0, 0.0, np.ones(5))
    jax.tree_util.tree_map(lambda r, g: np.testing.assert_array_equal(np.asarray(r), g),
                           {k: v for k, v in js.device_state().items() if k != "n"},
                           {k: v.numpy() for k, v in _one_row().device_state().items()
                            if k != "n"})


def _one_row():
    b = SimpleReplayBuffer(10, 5, ACT, device="cpu")
    b.add_sample(np.ones(5), np.ones(ACT), 1.0, 0.0, np.ones(5))
    return b
