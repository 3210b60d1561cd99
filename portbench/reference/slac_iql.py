"""SLAC (Lee et al., NeurIPS 2020) under IQL (Kostrikov et al., ICLR 2022)
written from the papers and the S2P experiment's settings in plain PyTorch:
the offline step that ``run_iql_image.sh`` trains, from the raw datasets.

Weights are dicts of tensors keyed by parameter name (``latent_spec``,
``critic_spec``, ``policy_spec``); frames are NHWC floats in [0, 1] at the
interface, NCHW inside. Every convolution and linear layer goes through
``prec`` (``precision.Precision``).

SLAC's latent model, over windows of S + 1 frames and S actions:

- z = (z1 ‖ z2); p(z1(0)) = N(0, I); p(z2(0) | z1(0)), p(z1(t+1) | z2(t),
  a(t)), p(z2(t+1) | z1(t+1), z2(t), a(t)) and the posteriors q(z1(0) |
  x(0)), q(z1(t+1) | x(t+1), z2(t), a(t)) are Gaussian heads: MLPs of
  leaky-ReLU(0.2) units to (mean, softplus(·) + 1e-5);
- the encoder: stride-2 convolutions to one feature vector a frame; the
  decoder: transposed convolutions from 1 × 1 back to the frame, the mean
  of a Gaussian of std √0.1; leaky ReLU(0.2) after every layer of both;
- the ELBO, each term summed over the window and the pixels and averaged
  over the batch: KL(q(z1) ‖ p(z1)) at t = 0 … S, −log N(x; decoder(z),
  0.1) at t = 0 … S, and −log N(r; head(z(t), a(t), z(t+1))) at t = 0 … S−1
  where the episode goes on.

IQL over the latent: twin Q(z, a) and V(z), MLPs of ReLU units; the Qs
regress to r + γ·(1 − d)·V(z′), V to the target Qs' minimum by the
expectile loss (τ = ``quantile``); the policy, a tanh-Gaussian, by
advantage-weighted regression, weights exp((Q − V)/β) clipped at
``clip_score``; Adam (ε 1e-8, bias-corrected) for each net; the target Qs
follow the critic's Qs by a soft update.

Departures from the published descriptions, as the S2P experiment runs
them:

- q(z2 | ·) is p(z2 | ·): one set of weights (SLAC's released code; the
  paper gives the posterior its own);
- the last decoder layer is followed by leaky ReLU too (the released code);
- the policy reads the feature-action window (S features and S − 1
  actions), the critics z(S − 1) and z(S) of a posterior sample, without
  gradients into the latent model; the latent model trains only by its
  own ELBO step on ``batch_size_latent`` windows after the RL step;
- the target Qs move with τ every ``target_update_period`` steps, the first
  included, after the critic's update; V has no target;
- the policy's log-density takes atanh of the action clipped to
  ±(1 − 1e-6) and log(1 − tanh²u) as 2(log 2 − u − softplus(−2u)); its
  log-std is clamped to [−20, 2];
- the generated step's reward is lowered by λ times its aleatoric
  uncertainty (S2P), and each generated window ends in a generated frame
  after 8 real ones.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision
from portbench.reference.train import Adam

Weights = Dict[str, torch.Tensor]
SENTINEL = 10 ** 9  # a window index of a step with no full window behind it

# (out channels, kernel, stride, padding) of each encoder conv; None: the feature width
ENCODER = {
    64: [(32, 5, 2, 2), (64, 3, 2, 1), (128, 3, 2, 1), (256, 3, 2, 1), (None, 4, 1, 0)],
    100: [(32, 5, 2, 2), (64, 3, 2, 1), (128, 3, 2, 1), (256, 3, 2, 1), (256, 3, 2, 1),
          (None, 4, 1, 0)],
}
# (out channels, kernel, stride, padding, output padding) of each transposed conv;
# None: the frame's channels
DECODER = {
    64: [(256, 4, 1, 0, 0), (128, 3, 2, 1, 1), (64, 3, 2, 1, 1), (32, 3, 2, 1, 1),
         (None, 5, 2, 2, 1)],
    100: [(256, 4, 1, 0, 0), (256, 3, 2, 1, 0), (128, 3, 2, 1, 0), (64, 3, 2, 1, 0),
          (32, 3, 2, 1, 1), (None, 5, 2, 2, 1)],
}
LOG_2PI = math.log(2 * math.pi)


# -- shapes ---------------------------------------------------------------------

def z_dim(cfg) -> int:
    return cfg["slac"]["z1_dim"] + cfg["slac"]["z2_dim"]


def feature_action_dim(cfg) -> int:
    S = cfg["num_sequences"]
    return S * cfg["slac"]["feature_dim"] + (S - 1) * cfg["action_dim"]


def head_io(cfg) -> Dict[str, tuple]:
    """(inputs, outputs) of each Gaussian head."""
    s, A = cfg["slac"], cfg["action_dim"]
    F_, z1, z2 = s["feature_dim"], s["z1_dim"], s["z2_dim"]
    return {"z2_prior_init": (z1, z2), "z1_prior": (z2 + A, z1), "z2_prior": (z1 + z2 + A, z2),
            "z1_posterior_init": (F_, z1), "z1_posterior": (F_ + z2 + A, z1),
            "reward": (2 * (z1 + z2) + A, 1)}


def encoder_layers(cfg) -> List[tuple]:
    """(in, out, kernel, stride, padding, output size) of each encoder conv."""
    out, c_prev, size = [], cfg["channels"], cfg["image_size"]
    for c, k, s, p in ENCODER[cfg["image_size"]]:
        c = cfg["slac"]["feature_dim"] if c is None else c
        size = (size + 2 * p - k) // s + 1
        out.append((c_prev, c, k, s, p, size))
        c_prev = c
    return out


def decoder_layers(cfg) -> List[tuple]:
    """(in, out, kernel, stride, padding, output padding, input size) of each
    transposed conv."""
    out, c_prev, size = [], z_dim(cfg), 1
    for c, k, s, p, op in DECODER[cfg["image_size"]]:
        c = cfg["channels"] if c is None else c
        out.append((c_prev, c, k, s, p, op, size))
        size = (size - 1) * s - 2 * p + k + op
        c_prev = c
    if size != cfg["image_size"]:
        raise ValueError(f"the decoder ends at {size}px, not {cfg['image_size']}")
    return out


def _mlp_spec(prefix: str, widths: Sequence[int], names: Sequence[str]) -> dict:
    spec = {}
    for name, i, o in zip(names, widths[:-1], widths[1:]):
        spec[f"{prefix}{name}.weight"] = (o, i)
        spec[f"{prefix}{name}.bias"] = (o,)
    return spec


def latent_spec(cfg) -> Dict[str, tuple]:
    """The latent model's parameters, each once (the posterior over z2 is the prior)."""
    hidden = list(cfg["slac"]["hidden_units"])
    spec = {}
    for name, (i, o) in head_io(cfg).items():
        widths = [i, *hidden, 2 * o]
        names = [str(2 * j) for j in range(len(widths) - 1)]
        spec.update(_mlp_spec(f"{name}.net.", widths, names))
    for j, (ci, co, k, *_rest) in enumerate(encoder_layers(cfg)):
        spec[f"encoder.net.{2 * j}.weight"] = (co, ci, k, k)
        spec[f"encoder.net.{2 * j}.bias"] = (co,)
    for j, (ci, co, k, *_rest) in enumerate(decoder_layers(cfg)):
        spec[f"decoder.net.{2 * j}.weight"] = (ci, co, k, k)
        spec[f"decoder.net.{2 * j}.bias"] = (co,)
    return spec


def _fc_names(n_hidden: int) -> List[str]:
    return [f"fc{i}" for i in range(n_hidden)] + ["last_fc"]


def critic_spec(cfg) -> Dict[str, tuple]:
    hidden, A = list(cfg["iql"]["critic_hidden"]), cfg["action_dim"]
    spec = {}
    for q in ("qf1", "qf2"):
        spec.update(_mlp_spec(f"{q}.", [z_dim(cfg) + A, *hidden, 1], _fc_names(len(hidden))))
    spec.update(_mlp_spec("vf.", [z_dim(cfg), *hidden, 1], _fc_names(len(hidden))))
    return spec


def policy_spec(cfg) -> Dict[str, tuple]:
    hidden, A = list(cfg["iql"]["policy_hidden"]), cfg["action_dim"]
    spec = _mlp_spec("", [feature_action_dim(cfg), *hidden, A], _fc_names(len(hidden)))
    spec.update(_mlp_spec("", [hidden[-1], A], ["last_fc_log_std"]))
    return spec


# -- the offline datasets as windows -----------------------------------------------

def _episodes(timeouts: np.ndarray) -> List[tuple]:
    """(start, stop) of each episode: each ends at a timeout row; rows after
    the last one form an episode of their own."""
    ends = np.flatnonzero(np.asarray(timeouts).ravel() == 1)
    starts = np.concatenate([[0], ends + 1])
    stops = np.concatenate([ends + 1, [len(timeouts)]])
    return [(int(a), int(b)) for a, b in zip(starts, stops) if b > a]


def windows(real: dict, gen: dict, S: int, penalty: float) -> dict:
    """Every training window of the two datasets, real first, as index
    tables into one frame pool: ``pool`` (uint8 frames: the real episodes'
    frames, then ``gen``'s observed frames, then its generated ones),
    ``frames`` [n, S + 1], ``actions`` [n, S, A], ``rewards`` [n, S] (numpy).

    A real window is S steps of one episode and the S + 1 frames around
    them, ending at each step from the S-th on; the dataset's last row is
    left out where it ends an episode. A generated window is the rows its
    ``slac_observation_indices`` name (none with a ``SENTINEL``), the last
    row left out where it ends an episode: S − 1 real steps, then row i − 1's
    generated step (its action, its frame, its reward less ``penalty`` times
    its aleatoric uncertainty)."""
    imgs, nxt = np.asarray(real["image_observations"]), np.asarray(real["image_observations_tp1"])
    acts, rews = np.asarray(real["actions"]), np.asarray(real["rewards"]).ravel()
    timeouts = np.asarray(real["timeouts"]).ravel()
    pool, frames, actions, rewards = [], [], [], []
    base = 0
    for start, stop in _episodes(timeouts):
        if stop == len(timeouts) and timeouts[-1] == 1:
            stop -= 1
        if stop - start < S:
            continue
        ep = np.concatenate([imgs[start:start + 1], nxt[start:stop]])  # frame k: before step k
        pool.append(ep)
        for t in range(S - 1, stop - start):
            frames.append(base + np.arange(t - S + 1, t + 2))
            actions.append(acts[start + t - S + 1:start + t + 1])
            rewards.append(rews[start + t - S + 1:start + t + 1])
        base += len(ep)
    obs_idx = np.asarray(gen["slac_observation_indices"])
    act_idx = np.asarray(gen["slac_action_indices"])
    g_timeouts = np.asarray(gen["timeouts"]).ravel()
    uncertainty = np.asarray(gen["aleatoric_uncertainty"]).reshape(len(g_timeouts), -1)[:, 0]
    reward = np.asarray(gen["rewards"]).ravel().astype(np.float64) - penalty * uncertainty
    g_obs, g_new = np.asarray(gen["image_observations"]), np.asarray(gen["image_observations_tp1"])
    pool += [g_obs, g_new]
    for i in range(len(obs_idx)):
        if (obs_idx[i] >= SENTINEL).any() or (i == len(obs_idx) - 1 and g_timeouts[i] == 1):
            continue
        frames.append(np.concatenate([base + obs_idx[i, :S], [base + len(g_obs) + i - 1]]))
        actions.append(np.concatenate([np.asarray(gen["original_actions"])[act_idx[i, :S - 1]],
                                       np.asarray(gen["actions"])[i - 1:i]]))
        rewards.append(np.concatenate([
            np.asarray(gen["original_rewards"]).ravel()[act_idx[i, :S - 1]], reward[i - 1:i]]))
    return dict(pool=np.concatenate(pool), frames=np.stack(frames),
                actions=np.stack(actions).astype(np.float32),
                rewards=np.stack(rewards).astype(np.float32))


def gather(table: dict, idx: torch.Tensor, device, dtype) -> tuple:
    """(frames [b, S + 1, H, W, C] in [0, 1], actions [b, S, A], rewards
    [b, S, 1], dones [b, S, 1]) of the windows ``idx`` (offline data has no
    terminal step)."""
    i = idx.cpu().numpy()
    x = torch.as_tensor(table["pool"][table["frames"][i]], device=device).float() / 255.0
    a = torch.as_tensor(table["actions"][i], device=device)
    r = torch.as_tensor(table["rewards"][i], device=device)[..., None]
    return x.to(dtype), a.to(dtype), r.to(dtype), torch.zeros_like(r, dtype=dtype)


# -- the networks -----------------------------------------------------------------

def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _mlp(W: Weights, prefix: str, names: Sequence[str], x, prec: Precision, act):
    for name in names[:-1]:
        x = act(prec.linear(x, W[f"{prefix}{name}.weight"], W[f"{prefix}{name}.bias"]))
    return prec.linear(x, W[f"{prefix}{names[-1]}.weight"], W[f"{prefix}{names[-1]}.bias"])


def head(W: Weights, cfg, name: str, x, prec: Precision):
    n = len(cfg["slac"]["hidden_units"]) + 1
    mean, std = _mlp(W, f"{name}.net.", [str(2 * j) for j in range(n)], x, prec,
                     _lrelu).chunk(2, dim=-1)
    return mean, F.softplus(std) + 1e-5


def encoder(W: Weights, cfg, x, prec: Precision):
    """frames [N, H, W, C] → features [N, feature_dim]."""
    h = x.permute(0, 3, 1, 2)
    for j, (_, _, _, s, p, _) in enumerate(encoder_layers(cfg)):
        h = _lrelu(prec.conv(h, W[f"encoder.net.{2 * j}.weight"], W[f"encoder.net.{2 * j}.bias"],
                             s, p))
    return h.flatten(1)


def decoder(W: Weights, cfg, z, prec: Precision):
    """z [N, z_dim] → the frames' mean [N, H, W, C]."""
    h = z[:, :, None, None]
    for j, (_, _, _, s, p, op, _) in enumerate(decoder_layers(cfg)):
        w, b = W[f"decoder.net.{2 * j}.weight"], W[f"decoder.net.{2 * j}.bias"]
        h = _lrelu(F.conv_transpose2d(prec.operand(h), prec.operand(w), b, s, p, op))
    return h.permute(0, 2, 3, 1)


def posterior(W: Weights, cfg, feats, acts, noise: Sequence[torch.Tensor], prec: Precision):
    """q(z | x, a) sampled with ``noise`` (z1 then z2 at t = 0 … S): the
    z1 means and stds and the z1 and z2 samples, each [B, S + 1, ·]."""
    eps = iter(noise)
    means, stds, z1s, z2s = [], [], [], []
    z2 = None
    for t in range(feats.shape[1]):
        if t == 0:
            m, s = head(W, cfg, "z1_posterior_init", feats[:, 0], prec)
        else:
            m, s = head(W, cfg, "z1_posterior", torch.cat([feats[:, t], z2, acts[:, t - 1]], 1),
                        prec)
        z1 = m + next(eps) * s
        m2, s2 = (head(W, cfg, "z2_prior_init", z1, prec) if t == 0 else
                  head(W, cfg, "z2_prior", torch.cat([z1, z2, acts[:, t - 1]], 1), prec))
        z2 = m2 + next(eps) * s2
        for out, v in zip((means, stds, z1s, z2s), (m, s, z1, z2)):
            out.append(v)
    return tuple(torch.stack(v, 1) for v in (means, stds, z1s, z2s))


def gaussian_nll(x, mean, std):
    return 0.5 * ((x - mean) / std) ** 2 + torch.log(std) + 0.5 * LOG_2PI


def elbo(W: Weights, cfg, x, a, r, d, noise, prec: Precision):
    """(KL, image NLL, reward NLL) of a window batch."""
    B, S1 = x.shape[:2]
    feats = encoder(W, cfg, x.flatten(0, 1), prec).reshape(B, S1, -1)
    q_mean, q_std, z1, z2 = posterior(W, cfg, feats, a, noise, prec)
    p_mean, p_std = head(W, cfg, "z1_prior", torch.cat([z2[:, :-1], a], -1), prec)
    p_mean = torch.cat([torch.zeros_like(p_mean[:, :1]), p_mean], 1)
    p_std = torch.cat([torch.ones_like(p_std[:, :1]), p_std], 1)
    kl = (torch.log(p_std) - torch.log(q_std)
          + (q_std ** 2 + (q_mean - p_mean) ** 2) / (2 * p_std ** 2) - 0.5)
    z = torch.cat([z1, z2], -1)
    mean = decoder(W, cfg, z.flatten(0, 1), prec).reshape(x.shape)
    image = gaussian_nll(x, mean, torch.full_like(mean, cfg["slac"]["decoder_std"]))
    r_mean, r_std = head(W, cfg, "reward", torch.cat([z[:, :-1], a, z[:, 1:]], -1), prec)
    reward = gaussian_nll(r, r_mean, r_std) * (1 - d)
    return kl.sum() / B, image.sum() / B, reward.sum() / B


def q_value(W: Weights, cfg, q: str, z, a, prec: Precision):
    names = _fc_names(len(cfg["iql"]["critic_hidden"]))
    return _mlp(W, f"{q}.", names, torch.cat([z, a], -1), prec, F.relu)


def v_value(W: Weights, cfg, z, prec: Precision):
    return _mlp(W, "vf.", _fc_names(len(cfg["iql"]["critic_hidden"])), z, prec, F.relu)


def policy_log_prob(W: Weights, cfg, fa, a, prec: Precision):
    """log π(a | fa) of the tanh-Gaussian policy, summed over the action."""
    h = fa
    for name in _fc_names(len(cfg["iql"]["policy_hidden"]))[:-1]:
        h = F.relu(prec.linear(h, W[f"{name}.weight"], W[f"{name}.bias"]))
    mean = prec.linear(h, W["last_fc.weight"], W["last_fc.bias"])
    log_std = prec.linear(h, W["last_fc_log_std.weight"], W["last_fc_log_std.bias"]).clamp(-20, 2)
    u = torch.atanh(a.clamp(-1 + 1e-6, 1 - 1e-6))
    log_n = -0.5 * ((u - mean) / torch.exp(log_std)) ** 2 - log_std - 0.5 * LOG_2PI
    log_det = 2 * (math.log(2) - u - F.softplus(-2 * u))
    return (log_n - log_det).sum(-1)


# -- the step ----------------------------------------------------------------------

def train_steps(cfg, weights: Dict[str, Weights], steps: List[dict], prec: Precision) -> dict:
    """``len(steps)`` offline steps from ``weights`` ({"latent", "critic",
    "policy"}: float32 tensors, copied; the target Qs start as the critic's).
    Each step is a dict of ``batch`` and ``latent`` (``gather`` tuples: the
    RL windows and the ELBO's) and their posterior ``noise`` and
    ``latent_noise``. Returns each step's losses, the first step's
    gradients and the parameters after the last step, per net (the targets
    under "target")."""
    q, s = cfg["iql"], cfg["slac"]
    P = {m: {k: v.detach().clone().float().requires_grad_() for k, v in weights[m].items()}
         for m in ("latent", "critic", "policy")}
    T = {k: v.detach().clone().float() for k, v in weights["critic"].items() if k[:2] == "qf"}
    betas = tuple(cfg["adam_betas"])
    opts = {"latent": Adam(P["latent"], s["lr_latent"], betas),
            "critic": Adam(P["critic"], q["qf_lr"], betas),
            "policy": Adam(P["policy"], q["policy_lr"], betas)}
    losses, first = [], None
    for step, draw in enumerate(steps):
        L, C, Pi = (prec.cast(P[m]) for m in ("latent", "critic", "policy"))
        # the RL step on a posterior sample of the frozen latent model
        x, a, r, d = draw["batch"]
        B, S1 = x.shape[:2]
        with torch.no_grad():
            feats = encoder(L, cfg, x.flatten(0, 1), prec).reshape(B, S1, -1)
            _, _, z1, z2 = posterior(L, cfg, feats, a, draw["noise"], prec)
            z_seq = torch.cat([z1, z2], -1)
            z, z_next, act = z_seq[:, -2], z_seq[:, -1], a[:, -1]
            fa = torch.cat([feats[:, :-1].flatten(1), a[:, :-1].flatten(1)], 1)
            Tc = prec.cast(T)
            target = (q["reward_scale"] * r[:, -1]
                      + (1 - d[:, -1]) * q["discount"] * v_value(C, cfg, z_next, prec))
            q_min = torch.minimum(q_value(Tc, cfg, "qf1", z, act, prec),
                                  q_value(Tc, cfg, "qf2", z, act, prec))
        q1, q2 = (q_value(C, cfg, k, z, act, prec) for k in ("qf1", "qf2"))
        v = v_value(C, cfg, z, prec)
        qf1_loss, qf2_loss = (((qk.float() - target.float()) ** 2).mean() for qk in (q1, q2))
        diff = v.float() - q_min.float()
        vf_loss = (torch.where(diff > 0, 1 - q["quantile"], q["quantile"]) * diff ** 2).mean()
        critic_loss = qf1_loss + qf2_loss + vf_loss
        adv = (q_min.float() - v.detach().float())[:, 0]
        w = torch.exp(adv / q["beta"]).clamp(max=q["clip_score"])
        policy_loss = (-policy_log_prob(Pi, cfg, fa, act, prec).float() * w).mean()
        rl = [p for m in ("critic", "policy") for p in P[m].values()]
        grads = dict(zip(rl, torch.autograd.grad(critic_loss + policy_loss, rl)))
        g = {m: {k: grads[p] for k, p in P[m].items()} for m in ("critic", "policy")}
        opts["critic"].step(g["critic"])
        opts["policy"].step(g["policy"])
        if step % q["target_update_period"] == 0:
            with torch.no_grad():
                for k in T:
                    T[k] = (1 - q["soft_target_tau"]) * T[k] + q["soft_target_tau"] * P["critic"][k]
        # the ELBO step
        kl, image, reward = elbo(L, cfg, *draw["latent"], draw["latent_noise"], prec)
        g["latent"] = dict(zip(P["latent"], torch.autograd.grad(
            kl.float() + image.float() + reward.float(), list(P["latent"].values()))))
        opts["latent"].step(g["latent"])
        losses.append({k: v.item() for k, v in dict(
            critic_loss=critic_loss, qf1_loss=qf1_loss, qf2_loss=qf2_loss, vf_loss=vf_loss,
            policy_loss=policy_loss, loss_kld=kl, loss_image=image, loss_reward=reward).items()})
        if step == 0:
            first = {m: {k: t.detach() for k, t in gm.items()} for m, gm in g.items()}
    params = {m: {k: v.detach() for k, v in P[m].items()} for m in P}
    params["target"] = T
    return dict(losses=losses, grads=first, params=params)
