"""The comparisons that decide ``correct``, and the controls that must fail them.

Each runs after the window, on what the timed calls produced, against the
plain reference in float32 with TF32 off, in chunks of rows so that it fits.
A generated frame is judged against the reference's frame from the same
state and the same previous frame: the program's own previous frame, so
that one step's error does not compound over a rollout.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

import torch

from portbench.reference import nets
from portbench.reference.precision import Precision, exact_f32
from portbench.reference.train import train_steps

F32 = Precision("f32")
Rollout = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # init [B,H,W,C], states [T,B,S], frames [T,B,H,W,C]


def f32_weights(weights: dict, device) -> dict:
    return {k: v.to(device=device, dtype=torch.float32) for k, v in weights.items()}


def _chunks(n: int, chunk: int):
    return [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]


@torch.no_grad()
def rollout_gaps(cfg, weights, rollouts: List[Rollout], device, chunk: int) -> Dict[str, float]:
    """``frame_max_gap``: the widest |frame − reference| over every value of
    every judged frame; ``frame_rms_gap``: their root mean square."""
    W = f32_weights(weights, device)
    worst, sq, n = 0.0, 0.0, 0
    with exact_f32():
        for init, states, frames in rollouts:
            init, states, frames = (t.to(device) for t in (init, states, frames))
            for t in range(states.shape[0]):
                prev = init if t == 0 else frames[t - 1]
                for lo, hi in _chunks(states.shape[1], chunk):
                    ref = nets.generator(W, cfg, states[t, lo:hi].float(), prev[lo:hi].float(), F32)
                    err = frames[t, lo:hi].float() - ref
                    worst = max(worst, err.abs().max().item())
                    sq += err.square().sum().item()
                    n += err.numel()
    return {"frame_max_gap": worst, "frame_rms_gap": math.sqrt(sq / n)}


@torch.no_grad()
def reference_rollouts(cfg, weights, rollouts: List[Rollout], prec: Precision, device,
                       chunk: int) -> List[Rollout]:
    """The judged rollouts made again by the reference in ``prec`` (a control
    in the program's place), each feeding back its own frames."""
    W = prec.cast(f32_weights(weights, device))
    out = []
    for init, states, _ in rollouts:
        img, frames = init.to(device, prec.dtype), []
        states = states.to(device, prec.dtype)
        for s in states:
            img = torch.cat([nets.generator(W, cfg, s[lo:hi], img[lo:hi], prec)
                             for lo, hi in _chunks(len(s), chunk)])
            frames.append(img)
        out.append((init, states, torch.stack(frames)))
    return out


OFF_STEPS = 16  # uint8 steps: 6% of the range, an error one sees


def to_uint8(frames: torch.Tensor) -> torch.Tensor:
    """[-1, 1] → uint8 as the bridge stores frames: (x + 1)·127.5, clipped, truncated."""
    return ((frames.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


@torch.no_grad()
def uint8_gaps(cfg, weights, prev: torch.Tensor, states: torch.Tensor, frames: torch.Tensor,
               device, chunk: int, report: Optional[dict] = None) -> Dict[str, float]:
    """``pixel_off_share``: the share of judged values more than
    ``OFF_STEPS`` uint8 steps from the reference; ``frame_off_share_max``:
    the same share within one frame, for the worst frame."""
    W = f32_weights(weights, device)
    per_frame = []
    with exact_f32():
        for lo, hi in _chunks(len(states), chunk):
            p = prev[lo:hi].to(device).float() / 127.5 - 1.0
            ref = to_uint8(nets.generator(W, cfg, states[lo:hi].to(device).float(), p, F32))
            per_frame.append((frames[lo:hi].to(device).int() - ref.int()).abs().flatten(1))
    d = torch.cat(per_frame)
    if report is not None:
        report["pixel_mean_step"] = d.float().mean().item()
        report["frame_mean_step_max"] = d.float().mean(1).max().item()
        for t in (2, 4, 8, 16):
            report[f"pixel_off{t}_share"] = (d > t).float().mean().item()
            report[f"frame_off{t}_share_max"] = (d > t).float().mean(1).max().item()
    off = (d > OFF_STEPS).float()
    return {"pixel_off_share": off.mean().item(), "frame_off_share_max": off.mean(1).max().item()}


@torch.no_grad()
def reference_uint8(cfg, weights, prev, states, prec: Precision, device, chunk: int):
    W = prec.cast(f32_weights(weights, device))
    out = []
    for lo, hi in _chunks(len(states), chunk):
        p = (prev[lo:hi].to(device).to(prec.dtype) / 127.5 - 1.0)
        out.append(to_uint8(nets.generator(W, cfg, states[lo:hi].to(device, prec.dtype), p, prec)))
    return torch.cat(out)


# training

def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    values = torch.stack([tensors[k].float().norm() for k in names]).tolist()
    return dict(zip(names, values))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """Per leaf |‖prog‖ − ‖ref‖| ÷ max(‖ref‖, the median leaf's ‖ref‖)."""
    median = statistics.median(ref.values())
    return {k: abs(prog[k] - r) / max(r, median) if max(r, median) > 0 else 0.0
            for k, r in ref.items()}


# The first step's feature-matching term: D's features of the fake against
# the real in L1, where rounding adds up instead of cancelling. The steps' D
# and G losses and their other terms are reported, not compared: no control
# or fault reads 3x the bf16 step there (the adversarial term sits near 0,
# and the later steps carry Adam's sign noise).
FM_TERM = "g_fm"
GRAD_FLOOR = 1e-3  # of the median leaf: a gradient this small moves a leaf by round-off alone


def moved_leaves(grads: Dict[str, float]) -> List[str]:
    median = statistics.median(grads.values())
    return [k for k, g in grads.items() if g >= GRAD_FLOOR * median]


def train_readings(run: dict, weights: dict) -> dict:
    """Per-step losses, the first gradient's per-leaf norms, and the per-leaf
    norms of the parameters' change after the steps, per module (G, D), of
    one run of the reference (``train_steps``)."""
    return dict(losses=run["losses"],
                grads={m: norms(g) for m, g in run["grads"].items()},
                change={m: norms({k: p - weights[m][k].to(p.device, torch.float32)
                                  for k, p in params.items()})
                        for m, params in run["params"].items()})


def train_gaps(prog: dict, ref: dict, report: Optional[dict] = None) -> Dict[str, float]:
    """``fm_loss_gap``: the relative gap of the first step's feature-matching
    term (``FM_TERM``); ``grad_gap``: the worst leaf's gap of the first gradient's norm;
    ``change_gap``: the worst leaf's gap of the change's norm, over the
    leaves whose reference gradient is at least ``GRAD_FLOOR`` of the median.
    ``report``, if given, gets ``leaves``: (gap, reading, module, leaf) of
    every leaf, and ``loss_terms``: (gap, "loss", step, term) of every term."""
    p0, r0 = prog["losses"][0], ref["losses"][0]
    loss = abs(p0[FM_TERM] - r0[FM_TERM]) / abs(r0[FM_TERM])
    if report is not None:
        report["loss_terms"] = [(abs(p[k] - r[k]) / abs(r[k]), "loss", step, k)
                                for step, (p, r) in enumerate(zip(prog["losses"], ref["losses"]))
                                for k in r if r[k] != 0]
        report["leaves"] = []
    gaps = {"grad_gap": 0.0, "change_gap": 0.0}
    for m in ref["grads"]:
        keep = moved_leaves(ref["grads"][m])
        for reading, by_leaf in (
                ("grad_gap", leaf_gaps(prog["grads"][m], ref["grads"][m])),
                ("change_gap", leaf_gaps({k: prog["change"][m][k] for k in keep},
                                         {k: ref["change"][m][k] for k in keep}))):
            gaps[reading] = max(gaps[reading], max(by_leaf.values()))
            if report is not None:
                report["leaves"].extend((g, reading, m, k) for k, g in by_leaf.items())
    return {"fm_loss_gap": loss, **gaps}


def reference_training(cfg, weights, batches, prec: Precision, device) -> dict:
    W = {m: f32_weights(w, device) for m, w in weights.items()}
    with exact_f32():
        return train_readings(train_steps(cfg, W, batches, prec), W)
