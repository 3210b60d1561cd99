"""The port's ensemble dynamics model (s2p_tpu_torch.world_model.ensemble)
against the JAX package's, on the CPU.

The same seeded numpy weights go into both packages: a JAX ``{"params":
...}`` tree with numpy leaves (shapes from ``jax.eval_shape`` of the flax
init, which is slow on the CPU), carried into the port by
``state_dict_from_jax_ensemble_params``. Tiny widths (hidden 16, 2 layers,
E = 7), f32: forward, loss and gradients at 1e-5 (gradients relative to the
largest one)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s2p_tpu.world_model import EnsembleTransition as JaxEnsemble
from s2p_tpu.world_model import convert_ensemble_state_dict
from s2p_tpu.world_model import ensemble_nll_loss as jax_nll_loss
from s2p_tpu.world_model import restore_members as jax_restore_members
from s2p_tpu.world_model import save_members as jax_save_members
from s2p_tpu.world_model import soft_clamp as jax_soft_clamp
from s2p_tpu_torch.world_model import (
    EnsembleTransition,
    ensemble_nll_loss,
    jax_ensemble_params_from_state_dict,
    make_ensemble_train_step,
    restore_members,
    save_members,
    soft_clamp,
    split_saved,
    state_dict_from_jax_ensemble_params,
)

OBS, ACT, E = 5, 3, 7
KW = dict(hidden_features=16, hidden_layers=2, ensemble_size=E)


def seeded_ensemble_params(model: JaxEnsemble, seed: int = 0) -> dict:
    """Seeded numpy weights in the shape of ``model``'s params: weights of
    std 1/√in, small non-zero biases, logstd bounds near their inits."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, model.obs_dim + model.action_dim)))["params"]
    rs = np.random.RandomState(seed)
    tree = {}
    for mod, node in shapes.items():
        if mod in ("max_logstd", "min_logstd"):
            base = 1.0 if mod == "max_logstd" else -5.0
            tree[mod] = (base + 0.1 * rs.randn(*node.shape)).astype(np.float32)
        else:
            w = node["weight"].shape
            tree[mod] = dict(weight=(rs.randn(*w) / np.sqrt(w[1])).astype(np.float32),
                             bias=(0.1 * rs.randn(*node["bias"].shape)).astype(np.float32))
    return {"params": tree}


def make_pair(seed: int = 0, **kw):
    """(JAX model, its numpy params, the port's model with the same weights
    on the CPU)."""
    jmodel = JaxEnsemble(obs_dim=OBS, action_dim=ACT, **KW, **kw)
    params = seeded_ensemble_params(jmodel, seed)
    model = EnsembleTransition(OBS, ACT, **KW, **kw, device="cpu")
    model.load_state_dict(state_dict_from_jax_ensemble_params(params), strict=True)
    return jmodel, params, model


def test_soft_clamp_matches_jax():
    x = np.linspace(-10, 10, 41).astype(np.float32)
    lo, hi = np.float32(-1.0), np.float32(2.0)
    ref = np.asarray(jax_soft_clamp(jnp.asarray(x), lo, hi))
    xt = torch.from_numpy(x).requires_grad_()
    out = soft_clamp(xt, torch.tensor(lo), torch.tensor(hi))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6, atol=1e-6)
    assert out.min() > -1.1 and out.max() < 2.1
    (g,) = torch.autograd.grad(out.sum(), xt)
    gref = np.asarray(jax.vmap(jax.grad(lambda v: jax_soft_clamp(v, lo, hi)))(jnp.asarray(x)))
    np.testing.assert_allclose(g.numpy(), gref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_reward", [True, False])
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("rank", [2, 3])
def test_forward_matches_jax(rank, mode, with_reward):
    jmodel, params, model = make_pair(mode=mode, with_reward=with_reward)
    shape = (4, OBS + ACT) if rank == 2 else (E, 4, OBS + ACT)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    mu_ref, std_ref = (np.asarray(v) for v in jax.jit(jmodel.apply)(params, x))
    with torch.no_grad():
        mu, std = model(torch.from_numpy(x))
    out_dim = OBS + int(with_reward)
    assert mu.shape == std.shape == mu_ref.shape == (E, 4, out_dim)
    np.testing.assert_allclose(mu.numpy(), mu_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std.numpy(), std_ref, rtol=1e-5, atol=1e-5)


def test_forward_matches_numpy_oracle():
    """The from-spec computation (tests/test_world_model.py:47): per-member
    einsum MLP, swish, soft-clamped logstd, residual observation mean."""
    _, params, model = make_pair(seed=3)
    p = params["params"]
    x = np.random.RandomState(0).randn(4, OBS + ACT).astype(np.float64)

    def swish(v):
        return v / (1 + np.exp(-v))

    def softplus(v):
        return np.logaddexp(0, v)

    h = swish(np.einsum("ij,bjk->bik", x, p["backbones_0"]["weight"]) + p["backbones_0"]["bias"])
    h = swish(np.einsum("bij,bjk->bik", h, p["backbones_1"]["weight"]) + p["backbones_1"]["bias"])
    out = np.einsum("bij,bjk->bik", h, p["output_layer"]["weight"]) + p["output_layer"]["bias"]
    mu_ref, logstd = np.split(out, 2, axis=-1)
    logstd = p["max_logstd"] - softplus(p["max_logstd"] - logstd)
    logstd = p["min_logstd"] + softplus(logstd - p["min_logstd"])
    mu_ref[..., :OBS] += x[None, :, :OBS]
    with torch.no_grad():
        mu, std = model(torch.from_numpy(x.astype(np.float32)))
    np.testing.assert_allclose(mu.numpy(), mu_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std.numpy(), np.exp(logstd), rtol=1e-5, atol=1e-5)


def test_local_mode_residual_with_zero_weights():
    _, _, model = make_pair()
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
        x = torch.from_numpy(np.random.RandomState(2).randn(3, OBS + ACT).astype(np.float32))
        mu, _ = model(x)
    np.testing.assert_array_equal(mu[..., :OBS].numpy(), x[:, :OBS].expand(E, 3, OBS).numpy())


def test_init_statistics_and_logstd_bounds():
    """Truncated normal of std 1/(2√in) cut at ±2σ (its own std is 0.8796σ),
    zero biases, logstd bounds +1 / −5; one seed gives one model, as JAX's
    init gives (compared by its statistics: the two generators differ)."""
    hidden = 256
    model = EnsembleTransition(17, 6, hidden_features=hidden, hidden_layers=3, device="cpu",
                               seed=3)
    again = EnsembleTransition(17, 6, hidden_features=hidden, hidden_layers=3, device="cpu",
                               seed=3)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    jmodel = JaxEnsemble(obs_dim=17, action_dim=6, hidden_features=hidden, hidden_layers=3)
    jw = np.asarray(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 23)))
                    ["params"]["backbones_1"]["weight"])
    for name, layer in [(f"backbones.{i}", b) for i, b in enumerate(model.backbones)] + \
            [("output_layer", model.output_layer)]:
        std = 1.0 / (2.0 * np.sqrt(layer.in_features))
        w = layer.weight.detach().numpy()
        assert w.shape == (7, layer.in_features, layer.out_features), name
        assert np.abs(w).max() <= 2 * std + 1e-7, name
        assert abs(w.std() / std - 0.8796) < 0.05, name
        assert not layer.bias.detach().any(), name
    std = 1.0 / (2.0 * np.sqrt(hidden))
    assert abs(model.backbones[1].weight.detach().numpy().std() - jw.std()) < 0.01 * std
    assert np.abs(jw).max() <= 2 * std + 1e-7
    np.testing.assert_array_equal(model.max_logstd.detach().numpy(), np.ones(18))
    np.testing.assert_array_equal(model.min_logstd.detach().numpy(), -5 * np.ones(18))


def test_save_restore_members_match_jax():
    _, params, model = make_pair(seed=0)
    _, params2, model2 = make_pair(seed=1)
    sd, sd2 = model.state_dict(), model2.state_dict()
    restored = restore_members(sd2, sd, [2, 5])
    jp, jp2 = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, params2))
    ref = jax_restore_members(jp2, jp, [2, 5])
    got = jax_ensemble_params_from_state_dict(restored)["params"]
    for mod, node in ref["params"].items():
        if isinstance(node, dict):
            for leaf, v in node.items():
                np.testing.assert_array_equal(got[mod][leaf], np.asarray(v), f"{mod}.{leaf}")
        else:
            np.testing.assert_array_equal(got[mod], np.asarray(node), mod)
    w = "backbones.0.weight"
    assert torch.equal(restored[w][2], sd[w][2]) and torch.equal(restored[w][0], sd2[w][0])
    assert torch.equal(restored["max_logstd"], sd2["max_logstd"])  # shared: untouched
    assert not torch.equal(sd2[w][2], sd[w][2])  # the inputs are not modified
    saved = save_members(sd, sd2, [0])
    np.testing.assert_array_equal(
        jax_ensemble_params_from_state_dict(saved)["params"]["output_layer"]["bias"],
        np.asarray(jax_save_members(jp, jp2, [0])["params"]["output_layer"]["bias"]))


@pytest.mark.parametrize("rank", [2, 3])
def test_nll_loss_and_gradients_match_jax(rank):
    """Gradients, not updated weights: Adam's first step is ≈ lr·sign(g), so
    float noise in a near-zero gradient would move a weight by ±lr."""
    jmodel, params, model = make_pair()
    rs = np.random.RandomState(3)
    lead = (16,) if rank == 2 else (E, 16)
    x = rs.randn(*lead, OBS + ACT).astype(np.float32)
    y = rs.randn(*lead, OBS + 1).astype(np.float32)
    loss_ref, g_ref = jax.jit(jax.value_and_grad(
        lambda p: jax_nll_loss(jmodel, p, x, y)))(params)
    loss = ensemble_nll_loss(model, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    ref = state_dict_from_jax_ensemble_params(jax.device_get(g_ref))
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref)
    scale = max(v.abs().max().item() for v in ref.values())
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def test_training_reduces_nll():
    _, _, model = make_pair()
    step = make_ensemble_train_step(model, lr=1e-3)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(256, OBS + ACT).astype(np.float32))
    y = x @ torch.from_numpy(rs.randn(OBS + ACT, OBS + 1).astype(np.float32) * 0.3)
    losses = [step(x, y).item() for _ in range(60)]
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_converters_round_trip_through_jax():
    """JAX's ``convert_ensemble_state_dict`` of the port's state dict gives
    JAX the port's forward; the port's own inverse gives back its tree."""
    jmodel, params, model = make_pair(seed=4)
    x = np.random.RandomState(5).randn(3, OBS + ACT).astype(np.float32)
    conv = convert_ensemble_state_dict(model.state_dict())
    mu_ref, std_ref = jax.jit(jmodel.apply)({"params": conv["params"]}, x)
    with torch.no_grad():
        mu, std = model(torch.from_numpy(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(std.numpy(), np.asarray(std_ref), rtol=1e-6, atol=1e-6)
    tree = jax_ensemble_params_from_state_dict(model.state_dict())
    back = state_dict_from_jax_ensemble_params(tree)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    assert sorted(tree["params"]) == sorted(params["params"])


def test_reference_state_dict_with_saved_snapshot_loads():
    """A reference-format state dict (torch tensors, ``saved_weight``/
    ``saved_bias`` beside each layer's weight and bias) loads strictly once
    ``split_saved`` takes the snapshot off; JAX's converter agrees."""
    jmodel, params, _ = make_pair(seed=6)
    _, other, _ = make_pair(seed=7)
    sd = state_dict_from_jax_ensemble_params(params)
    snap = state_dict_from_jax_ensemble_params(other)
    ref_sd = dict(sd)
    for k in sd:
        if k.endswith((".weight", ".bias")):
            mod, leaf = k.rsplit(".", 1)
            ref_sd[f"{mod}.saved_{leaf}"] = snap[k]
    model_sd, saved = split_saved(ref_sd)
    assert sorted(model_sd) == sorted(sd) and sorted(saved) == sorted(
        k for k in sd if k.endswith((".weight", ".bias")))
    model = EnsembleTransition(OBS, ACT, **KW, device="cpu", seed=9)
    model.load_state_dict(model_sd, strict=True)
    x = np.random.RandomState(8).randn(3, OBS + ACT).astype(np.float32)
    conv = convert_ensemble_state_dict(ref_sd)
    assert "saved" in conv
    mu_ref, _ = jax.jit(jmodel.apply)({"params": conv["params"]}, x)
    with torch.no_grad():
        mu, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(saved["output_layer.weight"].numpy(),
                                  np.asarray(conv["saved"]["output_layer"]["weight"]))
