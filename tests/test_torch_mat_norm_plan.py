"""The MAT-norm kernels' launch plan (s2p_tpu_torch.gan.cuda_kernels.
mat_norm_plan), which runs on the host and so is tested here on the CPU: at
every norm shape of the main paths (the 64px/ngf=64 generator at batch 256
serving and at 4 in the tensor-parallel forward, the 100px/ngf=64 one at
batch 16 training, at 8 and 2 a rank in data-parallel training and at
batch 256 in the image bridge), in bf16 and f32, forward and backward (the bridge runs only
the forward; its backward plans are held to the same rule); the dry run's
ranks' f32 shapes (``cli.dryrun``: its GAN generator at 2 rows a rank, its
tensor-parallel one at batch 8); the streaming
path at 256²; and the choice of the scalar path from channel counts and
alignment. The kernels themselves are held to their plain versions on the
card by chip_smoke.py."""

from types import SimpleNamespace

import pytest
import torch

from s2p_tpu_torch.gan import cuda_kernels as ck
from s2p_tpu_torch.gan.generator import S2PGenerator

SMEM_PER_CTA = 232_448  # shared memory one CTA may use on Hopper


def norm_shapes(image_size: int, ngf: int = 64, n_up: int = 4) -> list:
    """(H, C) of every MAT norm of one generator step, from S2PGenerator's
    resolution chain and block widths (norm_0 on the block input, norm_1 on
    min(in, out), norm_s on the input when the width changes), as
    chip_smoke.norm_shapes takes them, without building the weights."""
    dims = SimpleNamespace(image_size=image_size, ngf=ngf, n_up=n_up)
    shapes = set()
    for size, (c_in, c_out) in zip(S2PGenerator.sizes.fget(dims),
                                   S2PGenerator.block_channels.fget(dims)):
        shapes |= {(size, c_in), (size, min(c_in, c_out))}
    return sorted(shapes)


MAIN_PATHS = [(256, 64, h, c) for h, c in norm_shapes(64)] + \
             [(16, 100, h, c) for h, c in norm_shapes(100)] + \
             [(256, 100, h, c) for h, c in norm_shapes(100)] + \
             [(b, 100, h, c) for b in (8, 2) for h, c in norm_shapes(100)] + \
             [(4, 64, h, c) for h, c in norm_shapes(64)]


# the dry run's ranks (testing/dryrun_worker.py: GAN_G at ROWS a rank, TP_G
# at ROWS·4), f32 only
DRYRUN_PATHS = [(2, 32, h, c) for h, c in norm_shapes(32, 8, 3)] + \
               [(8, 32, h, c) for h, c in norm_shapes(32, 32, 2)]


def test_main_path_shapes_are_the_generators():
    assert norm_shapes(64) == [(4, 512), (8, 256), (8, 512), (16, 128), (16, 256), (32, 64),
                               (32, 128), (64, 64)]
    assert norm_shapes(100) == [(7, 512), (13, 256), (13, 512), (25, 128), (25, 256),
                                (50, 64), (50, 128), (100, 64)]


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("batch,image_size,H,C", MAIN_PATHS,
                         ids=[f"{s}px-B{b}-{h}x{c}" for b, s, h, c in MAIN_PATHS])
def test_plan_at_main_path_shape(batch, image_size, H, C, dtype, direction):
    check_plan(batch, H, C, dtype, direction)


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("batch,image_size,H,C", DRYRUN_PATHS,
                         ids=[f"{s}px-B{b}-{h}x{c}" for b, s, h, c in DRYRUN_PATHS])
def test_plan_at_dryrun_shape(batch, image_size, H, C, direction):
    check_plan(batch, H, C, torch.float32, direction)


def check_plan(batch, H, C, dtype, direction):
    hw = H * H
    plan = ck.mat_norm_plan(batch, hw, C, dtype, direction, True)
    arrays = 1 if direction == "forward" else 2
    # a launch small enough that its re-reads meet L2 streams; every other fits
    small = arrays * batch * hw * C * dtype.itemsize <= ck.STREAM_BYTES
    # every main-path width is on the 32 grid (the vector path both ways); the dry run's 8
    # is scalar, its 16 scalar in the backward only
    assert plan.path == ("streaming" if small else "resident")
    assert plan.vec == (C % ck.VEC_MULTIPLE[direction] == 0)
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.grid == batch * -(-C // plan.tile_c) * plan.cluster
    assert plan.grid % plan.cluster == 0
    assert plan.pixels_per_cta * plan.cluster >= hw > plan.pixels_per_cta * (plan.cluster - 1)
    slice_bytes = arrays * plan.pixels_per_cta * plan.tile_c * dtype.itemsize
    assert small or slice_bytes <= ck.RESIDENT_BYTES
    assert plan.smem == (0 if small else slice_bytes) + ck.SCRATCH_BYTES_PER_CHANNEL * plan.tile_c
    assert plan.smem <= SMEM_PER_CTA
    if plan.vec:
        assert C % plan.tile_c == 0 and plan.tile_c * dtype.itemsize // 16 in (2, 4, 8)
    else:
        assert plan.tile_c == 32
    if H in (50, 100) and batch >= 16:  # at batch 16 (image, tile) groups alone would give
        # 32-64 CTAs; at batch 256 they give enough, but a whole 50² or 100² slice does not fit
        assert plan.grid >= 256 and plan.cluster > 1
    if hw >= ck.SPLIT_MIN_HW:  # k is raised until the aim, the largest k or the least pixels
        assert (plan.grid >= ck.TARGET_CTAS or plan.cluster == ck.CLUSTER_SIZES[-1]
                or -(-hw // (2 * plan.cluster)) < ck.MIN_SPLIT_PIXELS)
    if hw < ck.SPLIT_MIN_HW:  # small images: no cluster unless the slice needs one to fit
        assert plan.cluster == 1 or arrays * -(-hw // (plan.cluster // 2)) * plan.tile_c \
            * dtype.itemsize > ck.RESIDENT_BYTES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_bridge_shapes_split_only_to_fit(dtype):
    """The bridge's forward at batch 256: every (image, tile) group alone
    already passes TARGET_CTAS, so no shape splits for occupancy; images of
    50² and 100² split exactly as far as their slice needs to fit in
    RESIDENT_BYTES, smaller ones not at all."""
    for H, C in norm_shapes(100):
        plan = ck.mat_norm_plan(256, H * H, C, dtype, "forward", True)
        assert plan.path == "resident" and plan.vec, (H, C)
        assert 256 * C // plan.tile_c >= ck.TARGET_CTAS
        assert plan.cluster == next(
            k for k in ck.CLUSTER_SIZES
            if -(-H * H // k) * plan.tile_c * dtype.itemsize <= ck.RESIDENT_BYTES), (H, C)


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_256px_streams(dtype, direction):
    """256²×64 at batch 2 does not fit in shared memory even split 8 ways."""
    plan = ck.mat_norm_plan(2, 256 * 256, 64, dtype, direction, True)
    assert plan.path == "streaming"
    assert plan.cluster == 8 and plan.pixels_per_cta == 256 * 256 // 8
    assert plan.smem == ck.SCRATCH_BYTES_PER_CHANNEL * plan.tile_c


def _gb_halves(C, dtype, extra=0):
    """γ and β as the two channel halves of one [2, 5, 5, 2C + extra] tensor,
    β starting at channel C + extra (the fast path's γ‖β conv output has
    extra = 0)."""
    gb = torch.randn(2, 5, 5, 2 * C + extra).to(dtype)
    return gb[..., :C], gb[..., C + extra:]


@pytest.mark.parametrize("C", [12, 100, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_scalar_path_off_the_32_grid(C, dtype):
    x = torch.randn(2, 5, 5, C).to(dtype)
    for g, b in (_gb_halves(C, dtype), (torch.randn_like(x), torch.randn_like(x))):
        assert not ck.forward_plan(x, g, b).vec
        assert not ck.backward_plan(torch.randn_like(x), x, g).vec
        assert ck.forward_plan(x, g, b).tile_c == 32


def test_strided_beta_with_12_channels_is_scalar():
    """The fast path's β = gb[..., 12:] starts 24 bytes in (bf16)."""
    x = torch.randn(2, 5, 5, 12).to(torch.bfloat16)
    g, b = _gb_halves(12, torch.bfloat16)
    assert (b.data_ptr() - g.data_ptr()) % 16 == 8
    assert not ck.forward_plan(x, g, b).vec


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_vector_path_needs_aligned_pointers_and_strides(dtype):
    x = torch.randn(2, 5, 5, 64).to(dtype)
    g, b = _gb_halves(64, dtype)  # the fast path's layout: aligned
    assert ck.forward_plan(x, g, b).vec and ck.backward_plan(x, x, g).vec
    g, b = _gb_halves(64, dtype, extra=2)  # β two elements further in: misaligned
    assert not ck.forward_plan(x, g, b).vec
    g_odd = torch.randn(2, 5, 5, 66).to(dtype)[..., :64]  # pixel stride of 66 elements
    assert not ck.forward_plan(x, g_odd, g).vec
    assert not ck.backward_plan(x, x, g_odd).vec


@pytest.mark.parametrize("batch,hw,C,dtype,tile_c,cluster,path", [
    (16, 7 * 7, 512, torch.bfloat16, 64, 1, "streaming"),  # 32 channels would idle threads
    (16, 13 * 13, 256, torch.bfloat16, 32, 1, "streaming"),  # a narrower tile, not a split
    (16, 25 * 25, 128, torch.bfloat16, 16, 1, "streaming"),  # one CTA per SM by the tile
    (16, 25 * 25, 256, torch.bfloat16, 32, 1, "resident"),  # whole: 25² is not split
    (16, 50 * 50, 64, torch.bfloat16, 32, 8, "resident"),  # split while CTAs keep 256 px
    (2, 32 * 32, 64, torch.float32, 8, 4, "streaming"),  # the |mean| >> std cases of
    (32, 32 * 32, 64, torch.float32, 32, 4, "resident"),  # chip_smoke.py, split both ways
])
def test_small_shapes_split_only_while_ctas_keep_work(batch, hw, C, dtype, tile_c, cluster,
                                                      path):
    """A cluster split only on images of SPLIT_MIN_HW pixels or more and
    while each CTA keeps MIN_SPLIT_PIXELS pixels, a narrower tile only
    while each thread keeps two vectors per pass: on the card a cluster
    and more, smaller CTAs cost the small shapes more than they give
    (chip_smoke.py --sweep)."""
    plan = ck.mat_norm_plan(batch, hw, C, dtype, "forward", True)
    assert (plan.tile_c, plan.cluster, plan.path) == (tile_c, cluster, path)
    assert plan.pixels_per_cta >= min(hw, ck.MIN_SPLIT_PIXELS)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_scalar_shapes_of_chip_smoke_cover_every_path(direction):
    """The scalar shapes chip_smoke.py holds against the plain version reach
    resident and streaming, each whole and split over a cluster, per
    direction (over both types)."""
    seen = set()
    for dt in (torch.bfloat16, torch.float32):
        for batch, H, C in ((16, 13, 12), (16, 8, 100), (16, 5, 40), (2, 50, 100),
                            (8, 50, 100), (64, 25, 40)):
            plan = ck.mat_norm_plan(batch, H * H, C, dt, direction, True)
            assert not plan.vec and plan.tile_c == 32
            seen.add((plan.path, plan.cluster > 1))
    assert seen == {("resident", False), ("resident", True), ("streaming", False),
                    ("streaming", True)}
    assert ck.mat_norm_plan(8, 2500, 100, torch.float32, direction, True).cluster == 8


def test_plan_rejects_unknown_direction():
    with pytest.raises(ValueError, match="direction"):
        ck.mat_norm_plan(2, 16, 64, torch.float32, "sideways", True)


# -- the S2P cells' plans are held; StyleGAN's widths take the vector path ------------

# sha256 (first 16 hex digits) of repr(rows), rows = (H, C, vec_ok, tile_c, cluster,
# pixels_per_cta, smem, path, vec, grid) for every (H, C) of
# portbench/counts/mat_norm.py's norm_shapes, vec_ok True then False, as the plan was
# before the vector path took C = 16 (StyleGAN's 1024² layers)
S2P_PLAN_DIGESTS = {
    "s2p-cheetah-64/B1/bfloat16/forward": "49522c0c140f1235",
    "s2p-cheetah-64/B1/bfloat16/backward": "49522c0c140f1235",
    "s2p-cheetah-64/B1/float32/forward": "567f0110e4b21b6e",
    "s2p-cheetah-64/B1/float32/backward": "567f0110e4b21b6e",
    "s2p-cheetah-64/B16/bfloat16/forward": "ef2e58248e0d96a4",
    "s2p-cheetah-64/B16/bfloat16/backward": "8cb0aff401604800",
    "s2p-cheetah-64/B16/float32/forward": "da316c30cc83a48f",
    "s2p-cheetah-64/B16/float32/backward": "09e533b9996c078d",
    "s2p-cheetah-64/B256/bfloat16/forward": "a38c7731ad8e6f6d",
    "s2p-cheetah-64/B256/bfloat16/backward": "c133d78891ac7d07",
    "s2p-cheetah-64/B256/float32/forward": "a0cd433b164d4ff8",
    "s2p-cheetah-64/B256/float32/backward": "b6fa0f68b852c717",
    "s2p-walker-100/B1/bfloat16/forward": "cf7c0c42e04a066c",
    "s2p-walker-100/B1/bfloat16/backward": "cf7c0c42e04a066c",
    "s2p-walker-100/B1/float32/forward": "32ee89a72a0f8f32",
    "s2p-walker-100/B1/float32/backward": "693a039931388898",
    "s2p-walker-100/B16/bfloat16/forward": "3a147ce710cf9d46",
    "s2p-walker-100/B16/bfloat16/backward": "66252faa22f9b89b",
    "s2p-walker-100/B16/float32/forward": "5c4c2587825c5822",
    "s2p-walker-100/B16/float32/backward": "ba5aa529a0ece8e5",
    "s2p-walker-100/B256/bfloat16/forward": "e1a480b7c9672d1a",
    "s2p-walker-100/B256/bfloat16/backward": "6d7006a03105db2a",
    "s2p-walker-100/B256/float32/forward": "ade0c908ab4791d5",
    "s2p-walker-100/B256/float32/backward": "54298bddb08a756b",
}


def _plan_rows(cfg, batch, dtype, direction) -> list:
    from portbench.counts import mat_norm

    rows = []
    for h, c in sorted(mat_norm.norm_shapes(cfg)):
        for vec_ok in (True, False):
            p = ck.mat_norm_plan(batch, h * h, c, dtype, direction, vec_ok)
            rows.append((h, c, vec_ok, p.tile_c, p.cluster, p.pixels_per_cta, p.smem, p.path,
                         p.vec, p.grid))
    return rows


@pytest.mark.parametrize("key", sorted(S2P_PLAN_DIGESTS))
def test_s2p_cells_plans_are_unchanged(key):
    """Every plan at every norm shape of the S2P cells' configurations (the
    cells' batches and 1, bf16 and f32, forward and backward, aligned or
    not) is the one the S2P cells were measured with."""
    import hashlib
    import json
    from pathlib import Path

    name, batch, dtype, direction = key.split("/")
    cfg = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                      / f"{name}.json").read_text())
    rows = _plan_rows(cfg, int(batch[1:]), getattr(torch, dtype), direction)
    assert hashlib.sha256(repr(rows).encode()).hexdigest()[:16] == S2P_PLAN_DIGESTS[key]


# StyleGAN FFHQ 1024² at batch 32: (r, C) of its AdaIN layers → (tile_c, path) in bf16
STYLEGAN_PLANS = {(4, 512): (64, "streaming"), (8, 512): (64, "streaming"),
                  (16, 512): (64, "resident"), (32, 512): (64, "resident"),
                  (64, 256): (64, "resident"), (128, 128): (16, "resident"),
                  (256, 64): (64, "streaming"), (512, 32): (32, "streaming"),
                  (1024, 16): (16, "streaming")}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("res,C", sorted(STYLEGAN_PLANS))
def test_stylegan_shapes_take_the_vector_path(res, C, dtype):
    """Every AdaIN shape of a StyleGAN pass, 16 channels at 1024² too, moves
    16 bytes a load: 2 lanes of 8 bf16 channels (or 4 of f32) cover a pixel."""
    plan = ck.mat_norm_plan(32, res * res, C, dtype, "forward", True)
    assert plan.vec and C % plan.tile_c == 0 and plan.tile_c * dtype.itemsize // 16 >= 2
    if dtype == torch.bfloat16:
        assert (plan.tile_c, plan.path) == STYLEGAN_PLANS[(res, C)]
    if res >= 256:  # no slice fits in shared memory: x streams, split to the aim
        assert plan.path == "streaming" and plan.grid >= ck.TARGET_CTAS
    assert not ck.mat_norm_plan(32, res * res, C, dtype, "forward", False).vec


def test_styles_at_pixel_stride_zero_keep_the_vector_path():
    """γ and β as one [B, 2C] style tensor broadcast over the pixels: pixel
    stride 0, batch stride 2C, 16-byte aligned."""
    B, H, C = 2, 8, 16
    x = torch.randn(B, H, H, C).to(torch.bfloat16)
    style = torch.randn(B, 2 * C).to(torch.bfloat16)
    g = style[:, :C].view(B, 1, 1, C).expand(B, H, H, C)
    b = style[:, C:].view(B, 1, 1, C).expand(B, H, H, C)
    assert ck._batch_pixel_strides(g, "gamma") == (2 * C, 0)
    assert ck.forward_plan(x, g, b).vec
