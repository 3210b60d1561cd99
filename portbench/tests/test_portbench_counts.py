"""The FLOP and byte counts against the shapes the code runs."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import flops, mat_norm
from portbench.reference import nets
from portbench.reference.precision import Precision

ROOT = Path(__file__).resolve().parents[2]
# the generator configurations (the RL step's count is held in test_portbench_slac_iql.py)
CONFIGS = {p.stem: cfg for p in (ROOT / "portbench" / "configs").glob("*.json")
           if "ngf" in (cfg := json.loads(p.read_text()))}
F32 = Precision("f32")


def meta_weights(spec):
    return {k: torch.empty(s, device="meta") for k, s in spec.items()}


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("batch", [1, 3])
def test_generator_flops_match_the_flop_counter(name, batch):
    cfg = CONFIGS[name]
    W = meta_weights(nets.generator_spec(cfg))
    H = cfg["image_size"]
    state = torch.empty(batch, cfg["state_dim"], device="meta")
    prev = torch.empty(batch, H, H, cfg["out_channels"], device="meta")
    assert flops.generator_forward(cfg, batch) == counted(
        lambda: nets.generator(W, cfg, state, prev, F32))


def test_discriminator_and_vgg_flops_match_the_flop_counter():
    cfg = CONFIGS["s2p-walker-100"]
    H, B = cfg["image_size"], 2
    img = torch.empty(B, H, H, 3, device="meta")
    state = torch.empty(B, cfg["state_dim"], device="meta")
    W = meta_weights(nets.discriminator_spec(cfg))
    assert flops.discriminator_forward(cfg, B) == counted(
        lambda: nets.discriminator(W, cfg, state, img, img, F32))
    V = meta_weights(nets.vgg19_spec())
    assert flops.vgg19_forward(H, B) == counted(lambda: nets.vgg19_features(V, img, F32))


def test_train_step_flops_add_up():
    cfg = CONFIGS["s2p-walker-100"]
    g, d = flops.generator_forward(cfg, 16), flops.discriminator_forward(cfg, 16)
    v = flops.vgg19_forward(100, 16)
    assert flops.train_step(cfg, 16) == 4 * g + 9 * d + 3 * v + 3 * d / 16


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mat_norm_shapes_are_the_launches_the_port_makes(name, monkeypatch):
    """At a tiny width on the CPU (the shapes follow the same chain), the port's
    generator calls the MAT norm once per counted shape; the bytes are four
    arrays of each launch's x."""
    import s2p_tpu_torch.gan.generator as g

    cfg = dict(CONFIGS[name], ngf=4, state_embed_dim=8, mat_hidden=4)
    seen = []
    real = g.fused_mat_norm

    def spy(x, gamma, beta, eps=1e-5):
        seen.append((tuple(x.shape), x.numel() * x.element_size(), x.element_size()))
        return real(x, gamma, beta, eps)

    monkeypatch.setattr(g, "fused_mat_norm", spy)
    gen = g.S2PGenerator(cfg["state_dim"], device="cpu",
                         **{k: cfg[k] for k in ("image_size", "ngf", "state_freqs",
                                                "state_embed_dim", "n_up", "mat_hidden")})
    H = cfg["image_size"]
    with torch.no_grad():
        gen(torch.zeros(2, cfg["state_dim"]), torch.zeros(2, H, H, 3))
    shapes = {}
    for (b, h, w, c), nbytes, itemsize in seen:
        assert b == 2 and h == w
        shapes[(h, c)] = shapes.get((h, c), 0) + 1
        assert mat_norm.launch_bytes("forward", b, h, c, itemsize) == 4 * nbytes
        assert mat_norm.launch_bytes("backward", b, h, c, itemsize) == 5 * nbytes
    assert shapes == mat_norm.norm_shapes(cfg)


def test_bounds_at_the_cells_shapes():
    """The bounds the issue's predictions rest on (bytes at 3.35 TB/s)."""
    cheetah, walker = CONFIGS["s2p-cheetah-64"], CONFIGS["s2p-walker-100"]
    assert mat_norm.bound_s(cheetah, "forward", 256, 2) == pytest.approx(0.6811e-3, rel=1e-4)
    assert mat_norm.bound_s(walker, "forward", 256, 2) == pytest.approx(1.6791e-3, rel=1e-4)
    assert mat_norm.bound_s(walker, "backward", 16, 2) == pytest.approx(0.1312e-3, rel=1e-3)
