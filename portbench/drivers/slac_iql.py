"""IQL + SLAC offline training: ``IQLTrainer.train(random_batch(buffer,
batch, generator, rng))`` in a closed loop, one step a call, as
``core/simple_offline_rl_algorithm.py`` calls it for ``run_iql_image.sh``:
the IQL update on a posterior sample of the latent model, then the joint
ELBO step on ``batch_size_latent`` windows.

Traffic: a real dataset of ``real_rows`` rows and an augmented one of
``gen_rows`` rows (uint8 frames, actions, rewards and aleatoric
uncertainties in episodes of ``episode_len`` steps, drawn from the seed on
the device in set-up), ingested through the port's ``ingest_real``,
``mark_real`` and ``ingest_generated`` into the one buffer of
``cli/mujoco_finetune.make_slac``; each call's ``batch`` windows drawn on
the device from a generator seeded from the seed.

Set-up drives the trainer through its first ``checked_steps`` steps, each
on a batch drawn as the window draws it, with the posterior noise and the
ELBO step's windows and noise drawn from the seed and handed over
(``train(batch, prepare_noise, latent_draws)``), and keeps what the
comparison needs: each step's losses, every net's first gradient (Adam's
first moment after one step ÷ (1 − β1)) and the parameters' change. Then
``warmup_calls`` calls as the window makes them; the window continues from
there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import compare, harness
from portbench.reference import slac_iql as ref
from portbench.reference.precision import Precision, exact_f32

LOSSES = ("critic_loss", "policy_loss", "loss_kld", "loss_image", "loss_reward")
READINGS = ("loss_gap", "grad_gap", "change_gap")


def _timeouts(rows: int, episode_len: int) -> np.ndarray:
    t = np.zeros(rows, np.float32)
    t[episode_len - 1::episode_len] = 1.0
    return t


def datasets(ctx: harness.Ctx) -> tuple:
    """(real, augmented) datasets in the schemas the port ingests, from the seed."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n, m, ep, S = tr["real_rows"], tr["gen_rows"], tr["episode_len"], cfg["num_sequences"]
    H, C, A = cfg["image_size"], cfg["channels"], cfg["action_dim"]
    g = ctx.generator("traffic")
    host = lambda t: t.cpu().numpy()  # noqa: E731
    frames = host(torch.randint(0, 256, (n + 2 * m, H, H, C), generator=g, device=dev,
                                dtype=torch.uint8))
    uniform = lambda rows: host(torch.rand(rows, A, generator=g, device=dev) * 2 - 1)  # noqa: E731
    normal = lambda rows: host(torch.randn(rows, generator=g, device=dev))  # noqa: E731
    imgs = frames[:n]
    real = dict(image_observations=imgs,
                image_observations_tp1=np.concatenate([imgs[1:], imgs[-1:]]),
                actions=uniform(n), rewards=normal(n), timeouts=_timeouts(n, ep))
    # SLAC's window of each augmented row: the S + 1 rows ending at it; none in an
    # episode's first S rows
    step = np.arange(m) % ep
    obs_idx = np.arange(m)[:, None] - S + np.arange(S + 1)[None, :]
    obs_idx[step < S] = ref.SENTINEL
    gen = dict(image_observations=frames[n:n + m], image_observations_tp1=frames[n + m:],
               actions=uniform(m), rewards=normal(m), original_actions=uniform(m),
               original_rewards=normal(m),
               aleatoric_uncertainty=host(torch.rand(m, generator=g, device=dev)),
               timeouts=_timeouts(m, ep), slac_observation_indices=obs_idx,
               slac_action_indices=obs_idx[:, :-1].copy())
    return real, gen


class SlacIQL:
    latency = False

    def __init__(self, ctx: harness.Ctx):
        from s2p_tpu_torch.data.replay import random_batch
        from s2p_tpu_torch.rl import CriticSLAC, IQLTrainer, TanhGaussianPolicy
        from s2p_tpu_torch.slac import SlacAlgorithm

        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        s, q, A = cfg["slac"], cfg["iql"], cfg["action_dim"]
        if tr["uncertainty_type"] != "aleatoric":
            raise ValueError(f"the reference penalizes the aleatoric uncertainty only, not "
                             f"{tr['uncertainty_type']!r}")
        seed = lambda tag: harness.sub_seed(ctx.seed, tag)  # noqa: E731
        self.ctx, self.random_batch = ctx, random_batch
        self.slac = SlacAlgorithm(
            A, num_sequences=cfg["num_sequences"], buffer_size=cfg["buffer_size"],
            batch_size_latent=s["batch_size_latent"], lr_latent=s["lr_latent"],
            feature_dim=s["feature_dim"], z1_dim=s["z1_dim"], z2_dim=s["z2_dim"],
            hidden_units=tuple(s["hidden_units"]), image_size=cfg["image_size"],
            channels=cfg["channels"], seed=seed("slac"), device=dev)
        policy = TanhGaussianPolicy(self.slac.feature_action_dim, tuple(q["policy_hidden"]), A,
                                    seed=seed("policy")).to(dev)
        critic = CriticSLAC(self.slac.z_dim, A, tuple(q["critic_hidden"]),
                            seed=seed("critic")).to(dev)
        g = ctx.generator("weights")
        self.weights = {m: harness.seeded_weights(spec, g, dev) for m, spec in (
            ("latent", ref.latent_spec(cfg)), ("critic", ref.critic_spec(cfg)),
            ("policy", ref.policy_spec(cfg)))}
        # the posterior over z2 is the prior's module, registered under both names
        latent = self.weights["latent"]
        self.slac.latent.load_state_dict(
            {k: latent[k.replace("z2_posterior", "z2_prior")]
             for k in self.slac.latent.state_dict()}, strict=True)
        critic.load_state_dict(self.weights["critic"], strict=True)
        policy.load_state_dict(self.weights["policy"], strict=True)
        # the target Qs are copied from the critic here, so after its weights
        self.trainer = IQLTrainer(
            policy, critic, discount=q["discount"], reward_scale=q["reward_scale"],
            policy_lr=q["policy_lr"], qf_lr=q["qf_lr"], quantile=q["quantile"], beta=q["beta"],
            clip_score=q["clip_score"], soft_target_tau=q["soft_target_tau"],
            target_update_period=q["target_update_period"], slac_algo=self.slac,
            slac_policy_input_type=q["policy_input"],
            slac_update_period=s["slac_update_period"], freeze_slac=s["freeze_slac"],
            seed=seed("iql"), device=dev)

        self.datasets = datasets(ctx)
        real, gen = self.datasets
        buf = self.slac.buffer
        buf.ingest_real(real)
        buf.mark_real()
        buf.ingest_generated(gen, tr["uncertainty_type"], tr["uncertainty_lambda"])
        self.batches = ctx.generator("batches")
        self.rng = np.random.RandomState(seed("rng") % 2 ** 32)  # the flat buffers' sampler
        self.checked = self._checked_steps(tr["checked_steps"])
        for i in range(tr["warmup_calls"]):
            self.call(i)

    def batch(self):
        with self.ctx.span("train.batch"):
            return self.random_batch(self.slac.buffer, self.ctx.traffic["batch"], self.batches,
                                     self.rng)

    def _checked_steps(self, n: int) -> dict:
        cfg, dev, tr = self.ctx.config, self.ctx.device, self.trainer
        s, S, B = cfg["slac"], cfg["num_sequences"], self.ctx.traffic["batch"]
        nets = {"latent": self.slac.latent, "critic": tr.critic, "policy": tr.policy}
        opts = {"latent": self.slac.opt, "critic": tr.critic_opt, "policy": tr.policy_opt}
        every = dict(nets, target=tr.target_q)
        start = {m: {k: p.detach().clone() for k, p in net.named_parameters()}
                 for m, net in every.items()}
        slots = len(self.slac.buffer)
        g = self.ctx.generator("draws")

        def noise(rows):
            return [torch.randn(rows, d, generator=g, device=dev)
                    for _ in range(S + 1) for d in (s["z1_dim"], s["z2_dim"])]

        steps, losses, grads = [], [], None
        for i in range(n):
            # the batch's windows: the draw the buffer makes, made again on a copy
            replay = torch.Generator(device=dev)
            replay.set_state(self.batches.get_state())
            idx = torch.randint(0, slots, (B,), generator=replay, device=dev)
            batch = self.batch()
            draw = dict(idx=idx, noise=noise(B), latent_noise=noise(s["batch_size_latent"]),
                        latent_idx=torch.randint(0, slots, (s["batch_size_latent"],),
                                                 generator=g, device=dev))
            metrics = tr.train(batch, prepare_noise=draw["noise"],
                               latent_draws=(draw["latent_idx"], draw["latent_noise"]))
            losses.append({k: v.item() for k, v in metrics.items()})
            steps.append(draw)
            if i == 0:
                # an optimizer that took no step holds no moment: nothing reached it
                b1 = cfg["adam_betas"][0]
                grads = {m: compare.norms({k: opts[m].state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) / (1 - b1) for k, p in net.named_parameters()})
                    for m, net in nets.items()}
        change = {m: compare.norms({k: p.detach() - start[m][k] for k, p in net.named_parameters()})
                  for m, net in every.items()}
        return dict(steps=steps, slots=slots, readings=dict(losses=losses, grads=grads,
                                                            change=change))

    def call(self, i: int) -> dict:
        self.trainer.train(self.batch())
        return {"steps": 1}

    def finish(self) -> dict:
        judged = dict(self.checked, weights=self.weights, datasets=self.datasets)
        del self.trainer, self.slac
        return judged


def setup(ctx):
    return SlacIQL(ctx)


def reference_readings(ctx, judged, prec: Precision, half: bool = False):
    """The reference's readings of the checked steps, from the raw datasets,
    the seeded weights and the draws (``half``: each batch's first half
    only); None where its windows are not as many as the buffer's slots."""
    cfg, dev = ctx.config, ctx.device
    table = ref.windows(*judged["datasets"], cfg["num_sequences"],
                        ctx.traffic["uncertainty_lambda"])
    if len(table["frames"]) != judged["slots"]:
        return None
    cut = (lambda t: t[:len(t) // 2]) if half else (lambda t: t)  # noqa: E731
    steps = [dict(batch=ref.gather(table, cut(d["idx"]), dev, prec.dtype),
                  noise=[cut(t).to(prec.dtype) for t in d["noise"]],
                  latent=ref.gather(table, cut(d["latent_idx"]), dev, prec.dtype),
                  latent_noise=[cut(t).to(prec.dtype) for t in d["latent_noise"]])
             for d in judged["steps"]]
    W = {m: compare.f32_weights(w, dev) for m, w in judged["weights"].items()}
    with exact_f32():
        run = ref.train_steps(cfg, W, steps, prec)
    start = dict(W, target={k: v for k, v in W["critic"].items() if k.startswith("qf")})
    return dict(losses=run["losses"], grads={m: compare.norms(g) for m, g in run["grads"].items()},
                change={m: compare.norms({k: p - start[m][k] for k, p in params.items()})
                        for m, params in run["params"].items()})


def gaps(prog: dict, refr: dict, report=None) -> dict:
    """``loss_gap``: the worst relative gap of the first step's losses
    (``LOSSES``); ``grad_gap``: the worst leaf's gap of the first gradient's
    norm; ``change_gap``: the worst leaf's gap of the change's norm, over the
    leaves whose reference gradient is at least ``compare.GRAD_FLOOR`` of the
    median (a target Q's leaf by its critic leaf's). ``report``, if given,
    gets ``leaves`` (gap, reading, net, leaf) and ``loss_terms`` (gap,
    "loss", step, term) of every step's losses."""
    p0, r0 = prog["losses"][0], refr["losses"][0]
    out = {"loss_gap": max(abs(p0[k] - r0[k]) / abs(r0[k]) for k in LOSSES),
           "grad_gap": 0.0, "change_gap": 0.0}
    if report is not None:
        report["loss_terms"] = [(abs(p[k] - r[k]) / abs(r[k]), "loss", step, k)
                                for step, (p, r) in enumerate(zip(prog["losses"], refr["losses"]))
                                for k in r if r[k] != 0]
        report["leaves"] = []
    for m, change in refr["change"].items():
        keep = [k for k in compare.moved_leaves(refr["grads"]["critic" if m == "target" else m])
                if k in change]
        by_reading = [("change_gap", compare.leaf_gaps({k: prog["change"][m][k] for k in keep},
                                                       {k: change[k] for k in keep}))]
        if m in refr["grads"]:
            by_reading.append(("grad_gap", compare.leaf_gaps(prog["grads"][m], refr["grads"][m])))
        for reading, by_leaf in by_reading:
            out[reading] = max(out[reading], max(by_leaf.values()))
            if report is not None:
                report["leaves"].extend((g, reading, m, k) for k, g in by_leaf.items())
    return out


def check(ctx, judged, report=None) -> dict:
    refr = reference_readings(ctx, judged, Precision("f32"))
    if refr is None:
        return {k: math.inf for k in READINGS}
    return gaps(judged["readings"], refr, report)


def control(ctx, judged, kind: str, report=None) -> dict:
    """Readings with a control in the program's place: the reference in
    ``kind`` precision, or (``half_batch``) the float32 reference on the
    first half of each batch."""
    half = kind == "half_batch"
    fake = reference_readings(ctx, judged, Precision("f32" if half else kind), half)
    return check(ctx, dict(judged, readings=fake), report)
