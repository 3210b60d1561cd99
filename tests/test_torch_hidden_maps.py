"""The hidden-map kernel's plain version and wrapper
(``s2p_tpu_torch.gan.cuda_kernels.hidden_maps``) against the op sequence
the fast path ran before it: the shared conv's bias (S2P: with the
constant-map terms, ``_add_const_map``), the ReLU and the split per norm.

The CUDA kernel itself is held to the plain version by the tests marked
``cuda`` (on a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_hidden_maps.py``) and by ``chip_smoke.py`` phase 27."""

import pytest
import torch

from s2p_tpu_torch.gan import S2PGenerator, SPADEGenerator, generate_rollout_fast, label_onehot
from s2p_tpu_torch.gan import cuda_kernels as ck
from s2p_tpu_torch.gan import fast_inference as fi
from s2p_tpu_torch.gan.fast_inference import _add_const_map, _cl

SIZES = [(1, 1), (1, 5), (2, 2), (4, 4), (7, 7), (13, 13), (25, 25)]
WIDTHS = {"equal": (8, 8, 8), "unequal": (5, 12, 3)}  # 5, 12, 3: off the 16-byte vector
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # rtol and atol, the norm kernels'


def operands(H, W, widths, dtype, terms=True, batch=2, seed=0, device="cpu"):
    """h (channels_last), the bias and the terms as ``t_all[:, :, off:off + C]``
    of a wider ``t_all``, as ``fast_apply`` slices them per block."""
    g = torch.Generator().manual_seed(seed)
    C = sum(widths)
    h = torch.randn(batch, C, H, W, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)
    bias = torch.randn(C, generator=g).to(dtype)
    t = None
    if terms:
        t_all = torch.randn(batch, 9, C + 11, generator=g).to(dtype)
        t = t_all[:, :, 7:7 + C]
    return h.to(device), bias.to(device), None if t is None else t.to(device)


def op_sequence(h, bias, widths, terms):
    """The fast path's hidden maps before the kernel, in h's type."""
    h = h.clone()
    if terms is None:
        h = h + bias[None, :, None, None]
    else:
        _add_const_map(h, terms, bias)
    return torch.split(h.relu_(), list(widths), dim=1)


@pytest.mark.parametrize("terms", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", sorted(WIDTHS))
@pytest.mark.parametrize("H,W", SIZES)
def test_plain_is_the_op_sequence_rounded_once(H, W, widths, dtype, terms):
    """In f32 the plain version adds in the sequence's order: equal bit for
    bit. In bf16 it rounds once where the sequence rounds at every step:
    equal to the sequence run in f32 and rounded, and within the bf16 steps
    of the sequence in bf16. At H or W = 1 both edges and all four corners
    land on one pixel, in both."""
    widths = WIDTHS[widths]
    h, bias, t = operands(H, W, widths, dtype, terms)
    got = ck.hidden_maps_plain(h, bias, widths, t)
    f32 = op_sequence(h.float(), bias.float(), widths, None if t is None else t.float())
    seq = op_sequence(h, bias, widths, t)
    assert len(got) == len(widths)
    for m, want, step in zip(got, f32, seq):
        assert m.dtype == dtype and m.shape == want.shape
        assert torch.equal(m, want.to(dtype))
        torch.testing.assert_close(m.float(), step.float(), rtol=2 ** -6, atol=2 ** -5)


@pytest.mark.parametrize("terms", [True, False])
def test_maps_are_channels_last_in_one_allocation(terms):
    """Each map is channels_last-contiguous (``_modulate``'s ``_cl`` returns
    it as is), norm k's at B·H·W·(F_0 + … + F_{k−1}) of one allocation."""
    widths = WIDTHS["unequal"]
    h, bias, t = operands(7, 5, widths, torch.bfloat16, terms)
    maps = ck.hidden_maps(h, bias, widths, t)
    base, n = maps[0].data_ptr(), 2 * 7 * 5
    for k, m in enumerate(maps):
        assert m.is_contiguous(memory_format=torch.channels_last)
        assert _cl(m).data_ptr() == m.data_ptr()
        assert m.data_ptr() == base + n * sum(widths[:k]) * m.element_size()


@pytest.mark.parametrize("bad", ["dtype", "bias_dtype", "device", "bias_shape", "h_shape",
                                 "terms_shape", "terms_stride", "width_sum", "no_widths",
                                 "zero_width", "five_widths"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    widths = (8, 8)
    h, bias, t = operands(4, 4, widths, torch.float32)
    args = dict(h=h, bias=bias, widths=widths, terms=t)
    args.update(dict(
        dtype=dict(h=h.double(), bias=bias.double(), terms=t.double()),
        bias_dtype=dict(bias=bias.bfloat16()),
        device=dict(bias=bias.to("meta")),
        bias_shape=dict(bias=bias[:-1]),
        h_shape=dict(h=h[0]),
        terms_shape=dict(terms=t[:, :8]),
        terms_stride=dict(terms=t.transpose(1, 2).contiguous().transpose(1, 2)),
        width_sum=dict(widths=(8, 7)),
        no_widths=dict(widths=()),
        zero_width=dict(widths=(16, 0)),
        five_widths=dict(widths=(4, 4, 4, 2, 2)),
    )[bad])
    with pytest.raises(ValueError, match="hidden_maps"):
        ck.hidden_maps(**args)


def test_wrapper_raises_under_recording_autograd():
    """The kernel has no backward: training's norms never call it."""
    h, bias, t = operands(4, 4, (8, 8), torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        ck.hidden_maps(h.requires_grad_(), bias, (8, 8), t)
    with torch.no_grad():
        ck.hidden_maps(h, bias, (8, 8), t)


# -- the wiring: one call a block and pass, on the fast path only --------------

S2P = dict(image_size=32, ngf=8, n_up=4, state_freqs=2, state_embed_dim=16, mat_hidden=8)


@pytest.fixture
def spy(monkeypatch):
    """Every ``hidden_maps`` call of the fast path, with whether it had terms."""
    calls = []

    def record(h, bias, widths, terms=None):
        calls.append((tuple(h.shape), tuple(widths), terms is not None))
        return ck.hidden_maps(h, bias, widths, terms)

    monkeypatch.setattr(fi, "hidden_maps", record)
    return calls


def test_s2p_fast_path_calls_it_once_a_block_with_terms_and_the_module_path_never(spy):
    gen = S2PGenerator(3, device="cpu", seed=0, **S2P).requires_grad_(False)
    g = torch.Generator().manual_seed(0)
    init, states = torch.rand(2, 32, 32, 3, generator=g) * 2 - 1, torch.randn(2, 2, 3, generator=g)
    ck.hidden_maps.launches = ck.hidden_maps.cmap_launches = 0
    generate_rollout_fast(gen, init, states)
    blocks = len(gen.sizes)
    assert len(spy) == 2 * blocks and all(terms for *_, terms in spy)
    assert [s[2:] for s, *_ in spy[:blocks]] == [(n, n) for n in gen.sizes]
    del spy[:]
    with torch.no_grad():
        gen(states[0], init)
    assert spy == []
    # the CPU runs the plain version: nothing launches, nothing is counted
    assert ck.hidden_maps.launches == ck.hidden_maps.cmap_launches == 0


def test_spade_fast_path_calls_it_once_a_block_without_terms(spy):
    opt = dict(label_nc=9, contain_dontcare_label=True, no_instance=True, ngf=8, crop_size=32,
               aspect_ratio=1.0, num_upsampling_layers="normal",
               norm_G="spectralspadesyncbatch3x3", nhidden=8, use_vae=False)
    gen = SPADEGenerator(**opt, device="cpu").eval().requires_grad_(False)
    ids = torch.randint(0, gen.semantic_nc, (2, 32, 32), generator=torch.Generator().manual_seed(0),
                        dtype=torch.uint8)
    ck.hidden_maps.launches = 0
    fi.synthesize_fast(gen, ids)
    assert len(spy) == len(gen.schedule) == 7 and not any(terms for *_, terms in spy)
    assert sum(len(widths) for _, widths, _ in spy) == 18
    del spy[:]
    with torch.no_grad():
        gen(label_onehot(ids, gen.semantic_nc))
    assert spy == [] and ck.hidden_maps.launches == 0


# -- the launch plan -------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # (batch, H·W, widths, dtype, aligned) → (vec, lanes, threads, c_tiles, grid)
    ((256, 16, (128, 128), torch.bfloat16, True), (True, 32, 256, 1, 1)),
    ((256, 4096, (128, 128), torch.bfloat16, True), (True, 32, 256, 1, 4)),
    ((256, 169, (128,) * 3, torch.bfloat16, True), (True, 48, 240, 1, 4)),
    ((32, 65536, (128,) * 3, torch.bfloat16, True), (True, 48, 240, 1, 33)),
    ((32, 65536, (128,) * 3, torch.float32, True), (True, 96, 192, 1, 33)),
    ((256, 169, (128,) * 3, torch.bfloat16, False), (False, 256, 256, 2, 2)),
    ((2, 49, (5, 12, 3), torch.bfloat16, True), (False, 20, 240, 1, 2)),
])
def test_plan_at_the_main_path_shapes(case):
    (batch, hw, widths, dtype, aligned), want = case
    plan = ck.hidden_maps_plan(batch, hw, widths, dtype, aligned, 132)
    assert (plan.vec, plan.lanes, plan.threads, plan.c_tiles, plan.grid) == want
    assert plan.threads <= ck.HIDDEN_THREADS and plan.threads % plan.lanes == 0


# -- on a card --------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("terms", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", sorted(WIDTHS))
@pytest.mark.parametrize("H,W", SIZES)
def test_kernel_matches_the_plain_version(card, H, W, widths, dtype, terms):
    widths = WIDTHS[widths]
    h, bias, t = operands(H, W, widths, dtype, terms, batch=3, device=card)
    before = ck.hidden_maps.launches, ck.hidden_maps.cmap_launches
    with torch.no_grad():
        got = ck.hidden_maps(h, bias, widths, t)
    want = ck.hidden_maps_plain(h, bias, widths, t)
    torch.cuda.synchronize()
    assert (ck.hidden_maps.launches - before[0], ck.hidden_maps.cmap_launches - before[1]) == (
        1, int(terms))
    for m, w in zip(got, want):
        assert m.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(m.float(), w.float(), rtol=TOL[dtype], atol=TOL[dtype])
