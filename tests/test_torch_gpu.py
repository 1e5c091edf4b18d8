"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (``gpu`` marker) and skip without one. The
kernels have no CPU or interpret mode; the CPU tests hold the plain versions
against the JAX package instead. The file imports no JAX, so on the card
it runs without the suite's JAX conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -p no:cacheprovider -q
"""

import numpy as np
import pytest
import torch

from test_torch_resize_lanczos4 import SIZES as RESIZE_SIZES
from test_torch_resize_lanczos4 import TOPS, assert_resized_close, random_stack, size_id
from tmat_torch.models.unet import UNetXception
from tmat_torch.ops import down_block as db, focus_stack as fs
from tmat_torch.ops import resize_lanczos4 as rl
from tmat_torch.ops import zproj

# (batch, H, C, F): the test suite's block shapes, odd channel counts, and
# the three production blocks (patch 320, filters 64-512)
SHAPES = [(2, 16, 8, 16), (2, 16, 4, 8), (2, 8, 8, 16), (3, 10, 5, 12), (2, 32, 64, 128),
          (2, 16, 128, 256), (2, 8, 256, 512), (2, 160, 64, 128), (2, 80, 128, 256),
          (2, 40, 256, 512)]
# further shapes of the warpgroup form (C % 64 == 0, F % 128 == 0): pooled
# sizes that leave the last tile ragged (5 and 10 against tile 8, 6 against
# tile 4, 2 against 4), one image, batches that are multiples of nothing,
# a single tile, and widths between and beside the production blocks'; and
# shapes just outside it (F or C off the multiple), which the general form takes
MORE_SHAPES = [(1, 10, 64, 128), (3, 20, 64, 128), (7, 12, 128, 256), (5, 4, 256, 512),
               (1, 2, 64, 128), (3, 24, 128, 128), (2, 12, 64, 256), (1, 8, 192, 384),
               (2, 12, 64, 192), (2, 12, 96, 128), (2, 12, 72, 136)]


def expected_form(c, f, dtype):
    """The form ``pick_config`` takes for 16-byte aligned tensors, at the
    widths tested here (the warpgroup form's shared memory fits them all)."""
    return "wgmma" if dtype == torch.bfloat16 and c % 64 == 0 and f % 128 == 0 else "wmma"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES + MORE_SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype, first):
    """Both forms of the kernel, each at the shapes it takes. f32: atol
    2e-5. bf16: another summation order can move a rounding of t or u by one
    bf16 step, so within 2**-6 of the largest output."""
    b, h, c, f = shape
    assert db.launch_form(c, f, dtype) == expected_form(c, f, dtype)
    x, blk = db.random_block(np.random.RandomState(0), b, h, c, f, dtype, cuda)
    before = db.launches
    out = db.down_block(x, blk, first)
    torch.cuda.synchronize()
    assert db.launches == before + 1
    assert db.last_launch()[0] == expected_form(c, f, dtype)  # what these tensors were given
    ref = db.down_block_plain(x, blk, first)
    assert out.shape == ref.shape and out.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


# (C, F, dtype, (tile, x staged) or None where only the form is pinned, form)
LAUNCHES = [
    (64, 128, torch.bfloat16, (8, True), "wgmma"), (128, 256, torch.bfloat16, (4, True), "wgmma"),
    (256, 512, torch.bfloat16, (4, True), "wgmma"), (128, 128, torch.bfloat16, (4, True), "wgmma"),
    (64, 128, torch.float32, None, "wmma"), (128, 256, torch.float32, None, "wmma"),
    (256, 512, torch.float32, None, "wmma"), (5, 12, torch.bfloat16, (8, True), "wmma"),
    (64, 192, torch.bfloat16, None, "wmma"), (96, 128, torch.bfloat16, None, "wmma"),
    (512, 1024, torch.bfloat16, (2, False), "wmma"), (512, 1024, torch.float32, None, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", LAUNCHES, ids=lambda c: f"{c[0]}-{c[1]}-{str(c[2]).split('.')[-1]}")
def test_launch_configurations(cuda, case):
    """The bf16 production blocks take the warpgroup form with a staged x
    tile (tile 8, 4, 4); float32, odd or off-multiple widths take the
    general form; a block too wide for a staged x tile reads x from global
    memory in the general form; one that fits nowhere is refused."""
    c, f, dtype, config, form = case
    if form is None:
        with pytest.raises(ValueError, match="no down-block launch fits"):
            db.launch_config(c, f, dtype)
        with pytest.raises(ValueError, match="no down-block launch fits"):
            db.launch_form(c, f, dtype)
        x, blk = db.random_block(np.random.RandomState(3), 1, 4, c, f, dtype, cuda)
        with pytest.raises(RuntimeError, match="launch failed"):
            db.down_block(x, blk, True)
        with pytest.raises(RuntimeError, match="launched no kernel"):
            db.last_launch()
        return
    assert db.launch_form(c, f, dtype) == form
    if config is not None:
        assert db.launch_config(c, f, dtype) == config
    # what a launch on aligned tensors reports is what the query said
    x, blk = db.random_block(np.random.RandomState(3), 1, 4, c, f, dtype, cuda)
    db.down_block(x, blk, True)
    assert db.last_launch() == (form, *db.launch_config(c, f, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("first", [True, False])
def test_kernel_reading_x_from_global_matches_plain(cuda, first):
    x, blk = db.random_block(np.random.RandomState(4), 2, 8, 512, 1024, torch.bfloat16, cuda)
    out = db.down_block(x, blk, first)
    ref = db.down_block_plain(x, blk, first)
    torch.cuda.synchronize()
    tol = 2.0 ** -6 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["all", "x", "w2", "b1", "out_of_step"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_unaligned_tensors(cuda, dtype, which):
    """Contiguous views that start off a 16-byte boundary (all tensors, or
    one of them alone) take the general form with its element-wise loads.
    float32: the same result as aligned tensors, which take that form too.
    bf16: aligned tensors take the warpgroup form, which sums in another
    order, so both are held against the plain version."""
    x, blk = db.random_block(np.random.RandomState(2), 2, 16, 64, 128, dtype, cuda)

    def shifted(t, by=1):
        buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
        view = buf[by:].view(t.shape)
        view.copy_(t)
        return view

    if which == "all":
        xs, blks = shifted(x), {k: shifted(v) for k, v in blk.items()}
    elif which == "x":
        xs, blks = shifted(x), blk
    elif which == "out_of_step":  # x on an 8-byte boundary only
        xs, blks = shifted(x, 8 // x.element_size()), blk
    else:
        xs, blks = x, dict(blk, **{which: shifted(blk[which])})
    assert xs.data_ptr() % 16 or any(v.data_ptr() % 16 for v in blks.values())
    out = db.down_block(xs, blks, False)
    assert db.last_launch()[0] == "wmma"  # though the shape's query says wgmma for bf16
    aligned = db.down_block(x, blk, False)
    assert db.last_launch()[0] == db.launch_form(64, 128, dtype)
    ref = db.down_block_plain(x, blk, False)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert torch.equal(out, aligned)
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (aligned.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_wrapper_refuses_mixed_devices(cuda):
    x, blk = db.random_block(np.random.RandomState(0), 1, 8, 8, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="w1"):
        db.down_block(x, dict(blk, w1=blk["w1"].cpu()), True)


def random_folded_unet(rng, filters):
    """BN-folded UNet weights (``UNetXception``'s input) drawn from ``rng``."""

    def arr(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    down = [{"dw1": arr(9, c, scale=0.3), "w1": arr(c, f, scale=c ** -0.5), "b1": arr(f, scale=0.1),
             "dw2": arr(9, f, scale=0.3), "w2": arr(f, f, scale=f ** -0.5), "b2": arr(f, scale=0.1),
             "wr": arr(c, f, scale=c ** -0.5), "br": arr(f, scale=0.1)}
            for c, f in zip(filters[:-1], filters[1:])]
    ups, prev = [], filters[-1]
    for f in reversed(filters):
        ups.append({"k1": arr(3, 3, prev, f, scale=(9 * prev) ** -0.5), "b1": arr(f, scale=0.1),
                    "k2": arr(3, 3, f, f, scale=(9 * f) ** -0.5), "b2": arr(f, scale=0.1),
                    "wr": arr(prev, f, scale=prev ** -0.5), "br": arr(f, scale=0.1)})
        prev = f
    return {"entry": {"k": arr(3, 3, 1, filters[0], scale=1 / 3), "b": arr(filters[0], scale=0.1)},
            "down": down, "up": ups, "head": {"k": arr(3, 3, filters[0], 1, scale=0.1), "b": arr(1)}}


@pytest.mark.gpu
def test_unet_forward_goes_through_the_kernel(cuda):
    rng = np.random.RandomState(1)
    filters = (8, 16, 32)
    net = UNetXception(random_folded_unet(rng, filters), torch.bfloat16).to(cuda)
    batch = torch.tensor(rng.rand(4, 64, 64, 1).astype(np.float32), device=cuda)
    before = db.launches
    out = net(batch)
    torch.cuda.synchronize()
    assert db.launches == before + len(filters) - 1
    ref = net(batch, plain_down=True)
    assert torch.isfinite(out).all() and out.shape == (4, 64, 64, 1)
    assert (out - ref).abs().max().item() < 0.05


# (dtype, (B, Z, H, W), z_counts or None, largest value): the production
# shape, a ragged batch, 12-bit and full-range uint16, and float32 shapes
# with partial tiles and images smaller than the 4-pixel support
FOCUS_CASES = [
    ("uint8", (1, 8, 1024, 1024), None, 255), ("uint8", (4, 8, 512, 512), (8, 5, 1, 3), 255),
    ("uint8", (2, 3, 33, 257), (3, 2), 255), ("uint8", (1, 3, 1, 1), None, 255),
    ("uint16", (1, 12, 1024, 1024), None, 4095), ("uint16", (1, 4, 40, 40), None, 65535),
    ("float32", (1, 5, 100, 150), None, 255), ("float32", (1, 3, 64, 64), None, 255),
    ("float32", (1, 8, 33, 257), None, 255), ("float32", (1, 3, 5, 5), None, 1),
    ("float32", (1, 3, 2, 3), None, 1), ("float32", (3, 4, 1, 7), (4, 1, 2), 1),
    # interior tiles (cp.async, 4 elements a copy) and border tiles (index
    # tables) on one image; widths off a multiple of 4 or 16 (tables only,
    # or a ragged last tile); a single tile wide; one slice
    ("uint8", (2, 5, 300, 1000), (5, 3), 255), ("uint8", (1, 4, 131, 250), None, 255),
    ("uint8", (1, 4, 77, 244), None, 255), ("uint8", (3, 1, 64, 128), None, 255),
    ("uint8", (1, 3, 40, 1028), None, 255), ("uint16", (2, 3, 100, 260), (3, 1), 65535),
    ("uint16", (1, 2, 90, 1004), None, 4095), ("float32", (1, 4, 200, 512), None, 255),
    ("float32", (2, 3, 72, 250), (2, 3), 255),
]


def focus_input(dtype, shape, top, seed=0):
    x = np.random.RandomState(seed).rand(*shape) * top
    return torch.from_numpy(x.astype(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("case", FOCUS_CASES, ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}")
def test_focus_kernel_matches_plain(cuda, case):
    """uint8: equal, ties included. uint16 and float32: at most 1e-4 of the
    pixels differ, each a near-tie (the kernel is compiled without FMA
    contraction and sums in the plain version's order, so none is expected)."""
    dtype, shape, z_counts, top = case
    stacks = focus_input(dtype, shape, top).to(cuda)
    before = fs.launches
    out = fs.focus_stack(stacks, z_counts)
    torch.cuda.synchronize()
    assert fs.launches == before + 1
    assert out.dtype == stacks.dtype and tuple(out.shape) == (shape[0], *shape[2:])
    n_diff, far, _ = fs.compare_with_plain(out, stacks, z_counts)
    assert far == 0
    assert n_diff == 0 if dtype == "uint8" else n_diff <= 1e-4 * out.numel()


@pytest.mark.gpu
def test_focus_kernel_breaks_ties_by_the_first_slice(cuda):
    stacks = focus_input("uint8", (2, 6, 70, 90), 254, seed=1)
    stacks[:, -1] = stacks[:, 0] + 1  # the same scores on other values
    out = fs.focus_stack(stacks.to(cuda))
    assert torch.equal(out.cpu(), fs.focus_stack_plain(stacks))
    scores = fs.focus_scores(stacks)
    tie = scores[:, 0] == scores.amax(dim=1)  # then the last slice has that score too
    assert tie.float().mean() > 0.1 and torch.equal(scores[:, 0], scores[:, -1])
    assert torch.equal(out.cpu()[tie], stacks[:, 0][tie])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_focus_kernel_takes_depths_on_the_card_or_none(cuda, dtype):
    """An int32 tensor of depths on the card is taken as it is, ``None`` is
    the full depth (a null pointer to the kernel): each one launch, and the
    projections of the same host values."""
    stacks = focus_input(dtype, (3, 6, 150, 260), 255, seed=2).to(cuda)
    ragged = [6, 2, 4]
    before = fs.launches
    on_card = fs.focus_stack(stacks, torch.tensor(ragged, dtype=torch.int32, device=cuda))
    full = fs.focus_stack(stacks)
    torch.cuda.synchronize()
    assert fs.launches == before + 2
    assert torch.equal(on_card.cpu(), fs.focus_stack(stacks, ragged).cpu())
    assert torch.equal(full.cpu(), fs.focus_stack(stacks, [6] * 3).cpu())
    assert fs.compare_with_plain(full, stacks)[:2] == (0, 0)
    assert fs.compare_with_plain(on_card, stacks, ragged)[:2] == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_focus_kernel_holds_depths_on_the_card_to_the_stack(cuda, dtype):
    """The host cannot check depths that live on the card: the kernel takes a
    value under 1 as 1 and one over Z as Z, so it neither reads past the
    stack nor leaves a projection unwritten."""
    stacks = focus_input(dtype, (4, 5, 70, 150), 255, seed=3).to(cuda)
    wild = torch.tensor([0, 9, -3, 2], dtype=torch.int32, device=cuda)
    out = fs.focus_stack(stacks, wild)
    assert torch.equal(out.cpu(), fs.focus_stack(stacks, [1, 5, 1, 2]).cpu())


@pytest.mark.gpu
def test_focus_wrapper_refuses(cuda):
    stacks = focus_input("uint8", (2, 4, 32, 48), 255).to(cuda)
    with pytest.raises(ValueError, match="not contiguous"):
        fs.focus_stack(stacks[:, :, :, ::2])
    with pytest.raises(ValueError, match="not contiguous"):
        fs.focus_stack(stacks.permute(0, 1, 3, 2))
    for bad in ([0, 4], [1, 5], [4], [-1, 2]):
        with pytest.raises(ValueError, match="z_counts"):
            fs.focus_stack(stacks, bad)
    with pytest.raises(TypeError, match="uint8, uint16 or float32"):
        fs.focus_stack(stacks.to(torch.float16))
    with pytest.raises(TypeError, match="int32"):
        fs.focus_stack(stacks, torch.tensor([4, 4], device=cuda))  # int64
    with pytest.raises(ValueError, match="z_counts"):
        fs.focus_stack(stacks, torch.tensor([4, 4, 4], dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="z_counts"):
        fs.focus_stack(stacks, torch.tensor([4, 4], dtype=torch.int32))  # on the CPU


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 37, 61), (1, 3, 100, 400)])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_focus_kernel_takes_unaligned_tensors(cuda, dtype, shape):
    """A contiguous view that starts one element into its buffer: its
    interior tiles go through the index tables too (no 4-element copies)."""
    stacks = focus_input(dtype, shape, 255).to(cuda)
    buf = torch.empty(stacks.numel() + 1, dtype=stacks.dtype, device=cuda)
    view = buf[1:].view(stacks.shape)
    view.copy_(stacks)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    assert torch.equal(fs.focus_stack(view).cpu(), fs.focus_stack(stacks).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_plate_zproj_fs_goes_through_the_focus_kernel(cuda, dtype):
    """``plate_zproj(..., "fs")`` and ``proj_focus_stacking_batch``: one
    launch each, in the stacks' dtype; uint8 equal to the plain version,
    the others at most at near-ties."""
    from tmat_torch.parallel.plate import plate_zproj

    stacks = focus_input(dtype, (3, 6, 40, 52), {"uint8": 255, "uint16": 4095, "float32": 255}[dtype])
    before = fs.launches
    out = plate_zproj(stacks, "fs")  # a CPU tensor: the entry point moves it to the card
    batch = zproj.proj_focus_stacking_batch(stacks.to(cuda))
    torch.cuda.synchronize()
    assert fs.launches == before + 2
    assert out.device.type == "cuda" and out.dtype == stacks.dtype and torch.equal(out, batch)
    n_diff, far, _ = fs.compare_with_plain(out, stacks.to(cuda))
    assert far == 0 and (n_diff == 0 if dtype == "uint8" else n_diff <= 1e-3 * out.numel())


@pytest.mark.gpu
def test_plate_segment_goes_through_the_kernel(cuda):
    """``plate_segment`` of two wells with a bf16 UNet (filters 8-16-32,
    patch 64): two down-block launches per well, and within 2**-6 of the
    largest output of the same wells on the plain path (the bf16 rule of
    the down block's own tests)."""
    from tmat_torch.parallel.plate import plate_segment

    rng = np.random.RandomState(2)
    net = UNetXception(random_folded_unet(rng, (8, 16, 32)), torch.bfloat16).to(cuda)
    imgs = torch.tensor(rng.rand(2, 96, 80).astype(np.float32))
    before = db.launches
    out = plate_segment(imgs, net, 64, 2)
    torch.cuda.synchronize()
    assert db.launches == before + 2 * 2
    ref = plate_segment(imgs, lambda b: net(b, plain_down=True), 64, 2)
    assert out.shape == (2, 96, 80) and out.dtype == torch.float32 and torch.isfinite(out).all()
    diff, tol = (out - ref).abs().max().item(), 2.0 ** -6 * ref.abs().max().item()
    assert diff <= tol, (diff, tol)


@pytest.mark.gpu
def test_projections_go_through_the_focus_kernel(cuda):
    """``proj_focus_stacking`` (any axis), ``proj_masked`` and
    ``proj_masked_batch`` launch the kernel once each on a CUDA tensor."""
    stack = focus_input("uint8", (6, 40, 52), 255)
    ref = fs.focus_stack_plain(stack[None])[0]
    before = fs.launches
    assert torch.equal(zproj.proj_focus_stacking(stack.to(cuda)).cpu(), ref)
    moved = stack.permute(1, 2, 0).contiguous().to(cuda)
    assert torch.equal(zproj.proj_focus_stacking(moved, axis=2).cpu(), ref)
    assert torch.equal(zproj.proj_masked(stack.to(cuda), 4, "fs").cpu(),
                       fs.focus_stack_plain(stack[None], [4])[0].float())
    batch = torch.stack([stack, stack.flip(0)]).to(cuda)
    out = zproj.proj_masked_batch(batch, [6, 2], "fs")
    assert torch.equal(out.cpu(), fs.focus_stack_plain(batch.cpu(), [6, 2]).float())
    assert fs.launches == before + 4


@pytest.mark.gpu
@pytest.mark.parametrize("shape,sigmas", [((7, 96, 96), None), ((2, 64, 80), (1, 3))])
def test_sato_on_the_card_matches_the_cpu(cuda, shape, sigmas):
    """Sato on the card against the same function on the CPU (float32, no
    TF32): within 1e-5 of the largest response."""
    from tmat_torch.ops.sato import DEFAULT_SIGMAS, sato

    x = torch.from_numpy(np.random.RandomState(2).rand(*shape).astype(np.float32))
    sig = sigmas or DEFAULT_SIGMAS
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        card = sato(x.to(cuda), sig).cpu()
    host = sato(x, sig)
    assert (card - host).abs().max().item() <= 1e-5 * host.abs().max().item()


@pytest.mark.gpu
def test_region_expansion_on_the_card_matches_the_cpu(cuda):
    from tmat_torch.tools.compute_branches import _region_expansion

    rng = np.random.RandomState(3)
    vessels = torch.from_numpy(rng.rand(200, 180).astype(np.float32))
    seed = torch.from_numpy(rng.rand(200, 180) > 0.95)
    card = _region_expansion(seed.to(cuda), vessels.to(cuda), iters=10).cpu()
    assert torch.equal(card, _region_expansion(seed, vessels, iters=10))
    assert card.sum() > seed.sum()


@pytest.mark.gpu
def test_analyze_branches_launches_the_down_block(cuda):
    """The 2-D path runs each UNet forward through the kernel: three
    launches per forward, one forward per image; the 3-D path launches none."""
    from pathlib import Path

    from tmat_torch.models.unet import get_unet_patch_segmentor_from_cfg
    from tmat_torch.tools import compute_branches as cb

    cfg = Path(__file__).resolve().parents[1] / "model_training" / "binary_segmentation" / "configs"
    seg = get_unet_patch_segmentor_from_cfg(str(cfg / "unet_patch_segmentor_1.json"), device=cuda)
    forwards = [0]
    model_fn = seg._pred_fn

    def counted(batch):
        forwards[0] += 1
        return model_fn(batch)

    seg._pred_fn = counted
    rng = np.random.RandomState(4)
    img = (rng.rand(256, 256) * 20).astype(np.uint8)
    img[120:124, 20:236] = 200
    img[20:236, 60:63] = 180
    config = {"image_width_microns": 1000.0, "save_vis": False}
    before = db.launches
    for _ in range(2):
        res = cb.analyze_branches(img, seg, config, device=cuda)
    assert forwards[0] == 2 and db.launches == before + 3 * forwards[0]
    assert res.rows[0][0] == "" and len(res.rows[0][1]) == 3
    stack = np.stack([img, img // 2, img])
    before = db.launches
    res3 = cb.analyze_branches(stack, None, config, device=cuda)
    assert db.launches == before and res3.rows[0][1][0] >= 1


def _shipped_member(dtype, device, last_layer="conv4_block6_out", size=256):
    from pathlib import Path

    from tmat_torch.tools import compute_inv_depth as inv

    ens = Path(__file__).resolve().parents[1] / "model_training" / "best_ensemble"
    return inv.load_ensemble([ens / "best_finetune_weights_0.msgpack"], (size, size, 3), last_layer,
                             dtype, device)


@pytest.mark.gpu
def test_resnet_on_the_card_matches_the_cpu(cuda):
    """The shipped member in float32 (TF32 off) on the card against the CPU,
    probabilities within 1e-4; bf16 within 0.02 of the card's float32."""
    from tmat_torch.models.preprocess import prep_inv_depth_imgs_hybrid
    from tmat_torch.models.resnet import ensemble_forward
    from tmat_torch.models.synthetic import synth_invasion_image

    rng = np.random.RandomState(5)
    stack = np.stack([synth_invasion_image(rng, 512, invaded=bool(z % 2)) for z in range(4)])
    x_cpu = prep_inv_depth_imgs_hybrid(stack, (256, 256), "cpu")
    x_card = prep_inv_depth_imgs_hybrid(stack, (256, 256), cuda)
    assert (x_card.cpu() - x_cpu).abs().max().item() <= 1e-4
    host = ensemble_forward(_shipped_member(torch.float32, "cpu"), x_cpu)
    card32 = ensemble_forward(_shipped_member(torch.float32, cuda), x_card)
    card16 = ensemble_forward(_shipped_member(torch.bfloat16, cuda), x_card)
    assert card16.shape == (1, 4, 1) and card16.dtype == torch.float32
    assert (card32.cpu() - host).abs().max().item() <= 1e-4
    assert (card16 - card32).abs().max().item() <= 0.02


@pytest.mark.gpu
def test_predict_stack_on_the_card(cuda):
    """predict_stack on the card gives the member probabilities of the
    CPU's, for uint8 and uint16 stacks and a single 2-D image."""
    from tmat_torch.tools import compute_inv_depth as inv

    rng = np.random.RandomState(6)
    card = _shipped_member(torch.float32, cuda, size=64)
    host = _shipped_member(torch.float32, "cpu", size=64)
    for stack in ((rng.rand(3, 100, 90) * 255).astype(np.uint8),
                  (rng.rand(2, 70, 70) * 4095).astype(np.uint16),
                  (rng.rand(80, 80) * 255).astype(np.uint8)):
        out = inv.predict_stack(stack, card, (64, 64))
        assert out.dtype == np.float32 and out.shape == (1, 1 if stack.ndim == 2 else len(stack), 1)
        np.testing.assert_allclose(out, inv.predict_stack(stack, host, (64, 64)), atol=1e-4, rtol=0)


# the CPU tests' sizes, and a downsample whose tiles load their rows in chunks
RESIZE_CASES = RESIZE_SIZES + [((1, 2048, 300), (37, 256))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RESIZE_CASES, ids=size_id)
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_resize_kernel_matches_plain(cuda, dtype, case):
    """The Lanczos-4 kernel against its plain version on the card, within
    ``tests/test_torch_resize_lanczos4.py``'s tolerances, one launch a call."""
    shape_in, shape = case
    stack = random_stack(dtype, shape_in)
    x = torch.from_numpy(stack).to(cuda)
    before = rl.launches
    out = rl.resize_lanczos4(x, shape)
    torch.cuda.synchronize()
    assert rl.launches == before + 1 and out.device == x.device
    assert_resized_close(out.cpu().numpy(), rl.resize_lanczos4_plain(x, shape).cpu().numpy(), stack, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
@pytest.mark.parametrize("kind", ["constant_rows", "full_range"])
def test_resize_kernel_at_the_ends_of_the_range(cuda, dtype, kind):
    """Rows each of one value from 0 to the top of the range, and squares at
    0 and at the top, whose rings the integer outputs clip on both sides."""
    top = TOPS[dtype]
    if kind == "constant_rows":
        stack = np.repeat(np.linspace(0, top, 200)[:, None], 180, axis=1).astype(dtype)[None]
    else:
        rr, cc = np.mgrid[0:200, 0:180]
        stack = np.where(((rr // 10) + (cc // 10)) % 2 == 0, top, 0).astype(dtype)[None]
    out = rl.resize_lanczos4(torch.from_numpy(stack).to(cuda), (64, 48)).cpu().numpy()
    assert_resized_close(out, rl.resize_lanczos4_plain(torch.from_numpy(stack), (64, 48)).numpy(),
                         stack, (64, 48))
    if kind == "full_range" and dtype != "float32":
        assert out.min() == 0 and out.max() == top


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(7, 5, 13), (3, 1, 1), (1, 32, 4), (16, 32, 200)])
def test_resize_kernel_takes_other_tiles(cuda, monkeypatch, tile):
    """Tiles that ``plan`` would not pick for this size: ragged edges on
    both axes, a column a tile, one input row a load, more rows than used."""
    th, tw, rc = tile
    stack = random_stack("uint16", (2, 300, 200), seed=1)
    monkeypatch.setattr(rl, "plan", lambda *a: (th, tw, rc, rl._span(rl.band(200, 50), tw)))
    out = rl.resize_lanczos4(torch.from_numpy(stack).to(cuda), (40, 50)).cpu().numpy()
    assert_resized_close(out, rl.resize_lanczos4_plain(torch.from_numpy(stack), (40, 50)).numpy(),
                         stack, (40, 50))


@pytest.mark.gpu
def test_resize_wrapper_refuses_on_the_card(cuda):
    stack = torch.zeros((2, 64, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="not contiguous"):
        rl.resize_lanczos4(stack[:, :, ::2], (16, 16))
    with pytest.raises(TypeError, match="uint8, uint16 or float32"):
        rl.resize_lanczos4(stack.to(torch.int16), (16, 16))
    with pytest.raises(ValueError, match="at most 65535 slices"):
        rl.resize_lanczos4(torch.zeros((65536, 2, 2), dtype=torch.uint8, device=cuda), (1, 1))


@pytest.mark.gpu
def test_predict_rows_launches_the_resize_kernel_once_a_stack(cuda):
    from tmat_torch.tools import compute_inv_depth as inv

    rng = np.random.RandomState(8)
    stacks = [(f"S{i}", (rng.rand(3, 100, 90) * 255).astype(np.uint8)) for i in range(4)]
    card = _shipped_member(torch.bfloat16, cuda, size=64)
    before = rl.launches
    rows = inv.predict_rows(stacks, card, (64, 64), 0.5)
    assert rl.launches == before + len(stacks) and len(rows) == 12


def _grads_close(card, cpu):
    """Each leaf within 1e-4 of its largest |g|, floored at 1e-2 of the
    model's largest (a bias in front of a BatchNorm has only rounding noise)."""
    gmax = max(g.abs().max().item() for g in cpu.values())
    for k, g in cpu.items():
        tol = 1e-4 * max(g.abs().max().item(), 1e-2 * gmax)
        torch.testing.assert_close(card[k].cpu(), g, atol=tol, rtol=0, msg=k)


def _seg_batch(n=4, hw=64):
    rng = np.random.RandomState(3)
    x = rng.rand(n, hw, hw, 1).astype(np.float32)
    y = np.zeros_like(x)
    y[:, hw // 4: 3 * hw // 4, hw // 3: hw // 2] = 1
    return x, y


@pytest.mark.gpu
def test_unet_train_step_on_the_card_matches_the_cpu(cuda):
    """One step of the trainable UNet from the same weights and batch:
    loss 1e-5 relative, BN statistics 1e-6, gradients (TF32 off)."""
    from tmat_torch.models import train as T
    from tmat_torch.models.layers import flax_variables, load_flax_variables
    from tmat_torch.models.unet import build_unet_xception

    cpu = build_unet_xception(1, (64, 64), filter_counts=(8, 16, 32), bn_momentum=0.9, seed=2,
                              device="cpu")
    card = load_flax_variables(build_unet_xception(1, (64, 64), filter_counts=(8, 16, 32),
                                                   bn_momentum=0.9, device=cuda), flax_variables(cpu))
    x, y = _seg_batch()
    out = {}
    for name, net in (("cpu", cpu), ("card", card)):
        tx = T.adamw(1e-3)
        _, m = T.make_unet_train_step(tx)(T.init_train_state(net, tx), x, y)
        out[name] = (m["loss"].item(), {k: p.grad.detach().cpu() for k, p in net.named_parameters()},
                     flax_variables(net)["batch_stats"])
    assert abs(out["card"][0] - out["cpu"][0]) <= 1e-5 * out["cpu"][0]
    _grads_close(out["card"][1], out["cpu"][1])
    for k, leaves in out["cpu"][2].items():
        for leaf, a in leaves.items():
            np.testing.assert_allclose(out["card"][2][k][leaf], a, atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_train_state_resumes_on_the_card(cuda, tmp_path):
    """save/load gives byte-equal tensors and step; the next step's loss is
    equal and the weights stay within 2 x lr (cuDNN's backward is not
    bit-deterministic)."""
    from tmat_torch.models import train as T
    from tmat_torch.models.unet import build_unet_xception

    def fresh(seed):
        tx = T.adamw(1e-3)
        return T.init_train_state(build_unet_xception(1, (64, 64), filter_counts=(8, 16), seed=seed,
                                                      device=cuda), tx)

    step = T.make_unet_train_step(T.adamw(1e-3))
    x, y = _seg_batch()
    state = fresh(0)
    for _ in range(3):
        step(state, x, y)
    T.save_train_state(tmp_path / "s.msgpack", state)
    restored = T.load_train_state(tmp_path / "s.msgpack", fresh(1))
    assert restored.step == state.step == 3
    for a, b in zip(state.module.state_dict().values(), restored.module.state_dict().values()):
        assert torch.equal(a, b)
    _, ma = step(state, x, y)
    _, mb = step(restored, x, y)
    assert abs(ma["loss"].item() - mb["loss"].item()) <= 1e-6 * ma["loss"].item()
    for a, b in zip(state.module.parameters(), restored.module.parameters()):
        assert (a - b).abs().max().item() <= 2e-3


@pytest.mark.gpu
def test_frozen_resnet_step_on_the_card(cuda):
    """The classifier's frozen stage on the card leaves the base bit-equal;
    its fine-tune gradients match the CPU's (TF32 off)."""
    from tmat_torch.models import train as T
    from tmat_torch.models.layers import flax_variables, load_flax_variables
    from tmat_torch.models.resnet import build_trainable_resnet50_tl

    cpu = build_trainable_resnet50_tl(1, (32, 32, 3), "conv2_block3_out", seed=4, device="cpu")
    with torch.no_grad():
        cpu.head.kernel.copy_(torch.randn(256, 1, generator=torch.Generator().manual_seed(0)) * 0.01)
    card = load_flax_variables(build_trainable_resnet50_tl(1, (32, 32, 3), "conv2_block3_out",
                                                           device=cuda), flax_variables(cpu))
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 32, 32, 3) * 10).astype(np.float32)
    y = np.array([[0.0], [1.0], [1.0], [0.0]], np.float32)
    base0 = {k: t.clone() for k, t in card.state_dict().items() if k.startswith("base_model.")}
    tx = T.make_tl_optimizer(1e-2, base_trainable=False)
    state = T.init_train_state(card, tx)
    for _ in range(2):
        T.make_classifier_train_step(tx)(state, x, y)
    assert all(torch.equal(card.state_dict()[k], t) for k, t in base0.items())
    grads = {}
    for name, net in (("cpu", cpu), ("card", load_flax_variables(card, flax_variables(cpu)))):
        ft = T.make_tl_optimizer(1e-4, base_trainable=True)
        T.make_classifier_train_step(ft)(T.init_train_state(net, ft), x, y)
        grads[name] = {k: p.grad.detach().cpu() for k, p in net.named_parameters()}
    _grads_close(grads["card"], grads["cpu"])


# (B, H, Cin, Cout, kh, stride) of the int8 conv: the six mixed up convs of
# the production segmentor (u0-u2), the entry conv, a 1x1/s2 residual, and
# odd shapes (a ragged last tile in M and N, Cin off a multiple of 16)
INT8_SHAPES = [(2, 20, 512, 512, 3, 1), (2, 40, 512, 256, 3, 1), (2, 40, 256, 256, 3, 1),
               (2, 80, 256, 128, 3, 1), (2, 80, 128, 128, 3, 1), (2, 320, 1, 64, 3, 2),
               (2, 160, 64, 128, 1, 2), (3, 9, 5, 70, 3, 2), (2, 13, 48, 24, 1, 1), (1, 7, 16, 8, 3, 1)]
INT8_FORMS = [(torch.int8, False, False), (torch.int8, True, False), (torch.bfloat16, False, False),
              (torch.float32, False, False), (torch.float32, True, True), (torch.bfloat16, False, True)]
# (batch dtype, relu_in, requantised output's float rounding or None, output
# dtype, relu): a float batch requantised on load, alone (a lone int8 conv of
# the mixed forward) and with its output requantised (t1 of a fused up block)
INT8_FUSED_FORMS = [(torch.bfloat16, False, None, torch.bfloat16, False),
                    (torch.bfloat16, True, torch.bfloat16, torch.int8, True),
                    (torch.float32, True, torch.float32, torch.int8, False)]
# (Cin, Cout) where the warpgroup form applies (3x3 stride-1 convs of int8 or
# bfloat16 batches, Cin and Cout multiples of 128); else the mma.sync form
INT8_WGMMA = {(512, 512), (512, 256), (256, 256), (256, 128), (128, 128)}


def int8_case(shape, device, seed=0):
    from tmat_torch.ops import int8_conv as ic

    b, h, cin, cout, kh, _ = shape
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randint(-127, 128, (b, h, h, cin)).astype(np.int8), device=device)
    packed = ic.pack_weights(rng.randint(-127, 128, (kh, kh, cin, cout)).astype(np.int8)).to(device)
    # m keeps sums of up to 9 * 512 * 127**2 within a few hundred int8 steps
    vecs = [torch.tensor(v.astype(np.float32), device=device)
            for v in (rng.rand(cout) * 2e-4, rng.randn(cout), rng.rand(cout) * 3)]
    return x, packed, *vecs


def int8_float_batch(shape, dtype, device, seed=1):
    """A float batch at int8 scale 1 / inv_sx (some of it past +-127), its
    inv_sx, and an inv_next that puts a tenth of each output channel of
    ``int8_case``'s weights past +-127."""
    from tmat_torch.ops import int8_conv as ic

    b, h, cin, cout, kh, stride = shape
    rng = np.random.RandomState(seed)
    x = torch.tensor((rng.randn(b, h, h, cin) * 60).astype(np.float32), device=device).to(dtype)
    inv_sx = torch.tensor((rng.rand(cin) + 0.5).astype(np.float32), device=device)
    _, packed, m, c, _ = int8_case(shape, device)
    v = ic.conv2d_s8_plain(x, packed, kh, stride, m, c, out_dtype=torch.float32, inv_sx=inv_sx)
    inv_next = 127 / torch.quantile(v.abs().reshape(-1, cout)[:16384].cpu(), 0.9, dim=0).to(device)
    return x, inv_sx, inv_next


def expected_int8_form(shape, in_dtype):
    cin, cout = shape[2], shape[3]
    if in_dtype != torch.float32 and (cin, cout) in INT8_WGMMA:
        return "wgmma"
    return "mma_sync" if in_dtype == torch.int8 and cin % 16 == 0 else "mma_sync-gather"


@pytest.mark.gpu
@pytest.mark.parametrize("form", INT8_FORMS, ids=lambda f: f"{str(f[0]).split('.')[-1]}-relu{int(f[1])}-sout{int(f[2])}")
@pytest.mark.parametrize("shape", INT8_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_conv_kernel_matches_plain(cuda, shape, form):
    """Bit-equal: exact int32 sums, the epilogue rounded at the same points
    (the kernel is built without FMA contraction). The six up convs take
    the warpgroup form, the rest the mma.sync form."""
    from tmat_torch.ops import int8_conv as ic

    x, packed, m, c, sout = int8_case(shape, cuda)
    out_dtype, relu, use_sout = form
    args = (x, packed, shape[4], shape[5], m, c, relu, out_dtype, sout if use_sout else None)
    before = ic.launches
    out = ic.conv2d_s8(*args)
    torch.cuda.synchronize()
    assert ic.launches == before + 1
    assert ic.last_launch() == expected_int8_form(shape, torch.int8) == ic.launch_form(*shape[2:], shape[1])
    ref = ic.conv2d_s8_plain(*args)
    assert out.dtype == out_dtype and out.shape == ref.shape
    assert torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("form", INT8_FUSED_FORMS,
                         ids=lambda f: (f"{str(f[0]).split('.')[-1]}in-reluin{int(f[1])}-"
                                        f"{'rq' + str(f[2]).split('.')[-1] if f[2] else str(f[3]).split('.')[-1]}"))
@pytest.mark.parametrize("shape", INT8_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_conv_fused_forms_match_plain(cuda, shape, form):
    """A float batch requantised on load, and an output requantised for the
    next conv: bit-equal to the plain version, in both kernel forms."""
    from tmat_torch.ops import int8_conv as ic

    in_dtype, relu_in, mid, out_dtype, relu = form
    _, packed, m, c, _ = int8_case(shape, cuda)
    x, inv_sx, inv_next = int8_float_batch(shape, in_dtype, cuda)
    kw = {"inv_sx": inv_sx, "relu_in": relu_in}
    if mid is not None:
        kw.update(inv_next=inv_next, mid_dtype=mid)
    args = (x, packed, shape[4], shape[5], m, c, relu, out_dtype)
    out = ic.conv2d_s8(*args, **kw)
    torch.cuda.synchronize()
    assert ic.last_launch() == expected_int8_form(shape, in_dtype)
    ref = ic.conv2d_s8_plain(*args, **kw)
    assert out.dtype == out_dtype and torch.equal(out, ref)
    if out_dtype == torch.int8:  # not vacuous: the requantised outputs span the int8 range
        assert (ref.abs() == 127).any() and (ref != 0).float().mean() > 0.2


def int8_form_id(form):
    if len(form) == 3:
        return f"{str(form[0]).split('.')[-1]}-relu{int(form[1])}-sout{int(form[2])}"
    return (f"{str(form[0]).split('.')[-1]}in-reluin{int(form[1])}-"
            f"{'rq' + str(form[2]).split('.')[-1] if form[2] else str(form[3]).split('.')[-1]}")


# every epilogue form and fused form at the shapes the warpgroup form takes
INT8_MMA_SYNC_CASES = [(s, f) for s in INT8_SHAPES if (s[2], s[3]) in INT8_WGMMA
                       for f in INT8_FORMS + INT8_FUSED_FORMS]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,form", INT8_MMA_SYNC_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v[0], int) else int8_form_id(v))
def test_int8_conv_mma_sync_form_at_the_up_convs(cuda, shape, form):
    """The mma.sync form (the library built with TMAT_INT8_MMA_SYNC_ONLY)
    where the pick rule takes the warpgroup form, in every form: bit-equal
    to the plain version too."""
    from tmat_torch.ops import int8_conv as ic

    x, packed, m, c, sout = int8_case(shape, cuda)
    if len(form) == 3:
        out_dtype, relu, use_sout = form
        args, kw = (x, packed, shape[4], shape[5], m, c, relu, out_dtype, sout if use_sout else None), {}
    else:
        in_dtype, relu_in, mid, out_dtype, relu = form
        x, inv_sx, inv_next = int8_float_batch(shape, in_dtype, cuda)
        args = (x, packed, shape[4], shape[5], m, c, relu, out_dtype)
        kw = {"inv_sx": inv_sx, "relu_in": relu_in, **({"inv_next": inv_next, "mid_dtype": mid} if mid else {})}
    with ic.built_with("TMAT_INT8_MMA_SYNC_ONLY"):
        out = ic.conv2d_s8(*args, **kw)
        assert ic.last_launch() == ("mma_sync" if x.dtype == torch.int8 else "mma_sync-gather")
    torch.cuda.synchronize()
    assert out.dtype == out_dtype and torch.equal(out, ic.conv2d_s8_plain(*args, **kw))


@pytest.mark.gpu
def test_int8_conv_takes_an_unaligned_batch(cuda):
    """A batch view 16 bytes off alignment goes byte by byte, still equal."""
    from tmat_torch.ops import int8_conv as ic

    x, packed, m, c, _ = int8_case((2, 12, 32, 64, 3, 1), cuda)
    flat = torch.empty(x.numel() + 1, dtype=torch.int8, device=cuda)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    assert torch.equal(ic.conv2d_s8(shifted, packed, 3, 1, m, c), ic.conv2d_s8_plain(x, packed, 3, 1, m, c))
    assert ic.last_launch() == "mma_sync-gather"


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 5])
def test_int8_conv_warpgroup_form_takes_a_ragged_batch(cuda, b):
    """Batches whose pixels leave the last 128-row tile part empty, with
    tiles spanning two images, an unaligned batch (which goes to the
    mma.sync form) and an unaligned inv_sx (which the warpgroup form copies
    to shared memory by the float)."""
    from tmat_torch.ops import int8_conv as ic

    shape = (b, 20, 128, 256, 3, 1)
    x, packed, m, c, _ = int8_case(shape, cuda)
    xf, inv_sx, inv_next = int8_float_batch(shape, torch.bfloat16, cuda)
    kw = {"inv_sx": inv_sx, "relu_in": True, "inv_next": inv_next}
    for args, k, form in (((x, packed, 3, 1, m, c), {}, "wgmma"),
                          ((xf, packed, 3, 1, m, c, True), kw, "wgmma")):
        out = ic.conv2d_s8(*args, **k)
        assert ic.last_launch() == form
        assert torch.equal(out, ic.conv2d_s8_plain(*args, **k))
    flat = torch.empty(x.numel() + 16, dtype=torch.int8, device=cuda)
    shifted = flat[8:8 + x.numel()].view(x.shape)
    shifted.copy_(x)
    assert torch.equal(ic.conv2d_s8(shifted, packed, 3, 1, m, c), ic.conv2d_s8_plain(x, packed, 3, 1, m, c))
    assert ic.last_launch() == "mma_sync-gather"
    scales = torch.empty(inv_sx.numel() + 1, device=cuda)
    odd = scales[1:]
    odd.copy_(inv_sx)
    out = ic.conv2d_s8(xf, packed, 3, 1, m, c, True, inv_sx=odd, relu_in=True, inv_next=inv_next)
    assert ic.last_launch() == "wgmma"
    assert torch.equal(out, ic.conv2d_s8_plain(xf, packed, 3, 1, m, c, True, **kw))


@pytest.mark.gpu
def test_int8_conv_wrapper_refuses(cuda):
    from tmat_torch.ops import int8_conv as ic

    x, packed, m, c, _ = int8_case((1, 8, 16, 8, 3, 1), cuda)
    with pytest.raises(ValueError, match="packed weights on"):
        ic.conv2d_s8(x, packed.cpu(), 3, 1, m, c)
    with pytest.raises(ValueError, match="not contiguous"):
        ic.conv2d_s8(x.transpose(1, 2), packed, 3, 1, m, c)
    with pytest.raises(ValueError, match="aligned"):
        wide = torch.zeros(packed.numel() + 1, dtype=torch.int8, device=cuda)
        ic.conv2d_s8(x, wide[1:].view(packed.shape), 3, 1, m, c)
    with pytest.raises(ValueError, match="kernel sizes"):
        ic.conv2d_s8(x, packed, 5, 1, m, c)
    with pytest.raises(ValueError, match="inv_sx"):
        ic.conv2d_s8(x.to(torch.bfloat16), packed, 3, 1, m, c)
    with pytest.raises(ValueError, match="inv_next"):
        ic.conv2d_s8(x, packed, 3, 1, m, c, out_dtype=torch.bfloat16, inv_next=m)
    with pytest.raises(ValueError, match="inv_sx on cpu"):
        ic.conv2d_s8(x.float(), packed, 3, 1, m, c, inv_sx=torch.ones(16))


def random_folded(rng, fc):
    """``extract_folded``'s layout for a UNet of filters ``fc`` with random
    weights, the up convs scaled to keep activations near 1."""
    def arr(*shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    folded = {"_n": {"down": len(fc) - 1, "up": len(fc)},
              "entry": {"w": arr(3, 3, 1, fc[0], scale=0.3), "b": arr(fc[0], scale=0.1), "kind": "conv", "stride": 2}}
    for i, (ci, co) in enumerate(zip(fc[:-1], fc[1:])):
        folded.update({f"d{i}.dw1": {"w": arr(3, 3, 1, ci, scale=0.3), "b": None, "kind": "dw", "stride": 1},
                       f"d{i}.pw1": {"w": arr(1, 1, ci, co, scale=ci ** -0.5), "b": arr(co, scale=0.1),
                                     "kind": "conv", "stride": 1},
                       f"d{i}.dw2": {"w": arr(3, 3, 1, co, scale=0.3), "b": None, "kind": "dw", "stride": 1},
                       f"d{i}.pw2": {"w": arr(1, 1, co, co, scale=co ** -0.5), "b": arr(co, scale=0.1),
                                     "kind": "conv", "stride": 1},
                       f"d{i}.res": {"w": arr(1, 1, ci, co, scale=ci ** -0.5), "b": arr(co, scale=0.1),
                                     "kind": "conv", "stride": 2}})
    prev = fc[-1]
    for j, f in enumerate(reversed(fc)):
        for k, cin in ((1, prev), (2, f)):
            folded[f"u{j}.t{k}"] = {"w": arr(3, 3, cin, f, scale=(9 * cin) ** -0.5), "b": arr(f, scale=0.1),
                                    "kind": "convT", "stride": 1}
        folded[f"u{j}.res"] = {"w": arr(1, 1, prev, f, scale=prev ** -0.5), "b": arr(f, scale=0.1),
                               "kind": "conv", "stride": 1}
        prev = f
    folded["head"] = {"w": arr(3, 3, fc[0], 1, scale=0.1), "b": arr(1, scale=0.1), "kind": "conv", "stride": 1}
    return folded


@pytest.mark.gpu
def test_quantized_segmentor_launches_the_int8_kernel(cuda, tmp_path):
    """A small quantized segmentor on the card: 6 int8 and (here) 2 down-block
    launches per forward. In float32 (TF32 off) its probabilities are within
    0.02 of the CPU's mixed forward (a requantised input may round the other
    way where the card's convs sum in another order); in bfloat16 they are
    finite and within 0.05 of float32 on average."""
    from tmat_torch.models import quant as Q
    from tmat_torch.ops import int8_conv as ic

    rng = np.random.RandomState(2)
    fc = (16, 32, 64)
    x = torch.tensor(rng.rand(3, 64, 64, 1).astype(np.float32))
    folded = random_folded(rng, fc)
    scales = Q.calibrate(folded, x.numpy(), "cpu")
    qp = Q.quantize_mixed(folded, scales)
    ref = Q.forward_mixed(qp, x, torch.float32)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = Q.MixedUNetXception(qp, dtype).to(cuda).eval()
        before_i, before_d = ic.launches, db.launches
        outs[dtype] = model(x.to(cuda)).float().cpu()
        torch.cuda.synchronize()
        assert (ic.launches - before_i, db.launches - before_d) == (6, 2)
        assert torch.isfinite(outs[dtype]).all() and outs[dtype].shape == x.shape
    assert (outs[torch.float32] - ref).abs().max().item() <= 0.02
    assert (outs[torch.bfloat16] - ref).abs().mean().item() <= 0.05


@pytest.mark.gpu
def test_quantized_forward_fused_equals_unfused(cuda):
    """At widths of 128 and 256 the up convs take the warpgroup form: the
    fused up blocks (t1 requantises its bfloat16 input and writes t2's int8
    input) give probabilities equal to the requantisations as PyTorch
    passes (``up_main_unfused``)."""
    from tmat_torch.models import quant as Q
    from tmat_torch.ops import int8_conv as ic

    rng = np.random.RandomState(3)
    x = torch.tensor(rng.rand(4, 48, 48, 1).astype(np.float32))
    folded = random_folded(rng, (128, 256))
    model = Q.MixedUNetXception(Q.quantize_mixed(folded, Q.calibrate(folded, x.numpy(), "cpu")),
                                torch.bfloat16).to(cuda).eval()
    before = ic.launches
    fused = model(x.to(cuda))
    torch.cuda.synchronize()
    assert ic.launches - before == 4 and ic.last_launch() == "wgmma"
    model.up_main = model.up_main_unfused
    unfused = model(x.to(cuda))
    assert torch.isfinite(fused).all() and torch.equal(fused, unfused)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(25000, 6), (3, 3, 64, 128), (7,)], ids=str)
def test_prng_draws_equal_on_the_card_and_the_cpu(cuda, shape):
    """The threefry streams of ``core/prng.py`` give the same bits on the
    card as on the CPU (where the CPU tests hold them to ``jax.random``)."""
    from tmat_torch.core import prng

    key = prng.prng_key(3)
    np.testing.assert_array_equal(prng.random_bits(key, shape, cuda).cpu().numpy(),
                                  prng.random_bits(key, shape).numpy())
    np.testing.assert_array_equal(prng.uniform(key, shape, device=cuda).cpu().numpy(),
                                  prng.uniform(key, shape).numpy())
    np.testing.assert_array_equal(prng.truncated_normal(key, -2, 2, shape, cuda).cpu().numpy(),
                                  prng.truncated_normal(key, -2, 2, shape).numpy())


@pytest.mark.gpu
def test_trainable_inits_equal_on_the_card_and_the_cpu(cuda):
    from tmat_torch.models import layers
    from tmat_torch.models.resnet import build_trainable_resnet50_tl
    from tmat_torch.models.unet import build_unet_xception

    for build in (lambda d: build_unet_xception(1, (32, 32), filter_counts=(8, 16, 32), seed=4, device=d),
                  lambda d: build_trainable_resnet50_tl(1, (32, 32, 3), "conv3_block1_out", seed=4, device=d)):
        on_card, on_cpu = build(cuda).state_dict(), build("cpu").state_dict()
        assert list(on_card) == list(on_cpu)
        for k in on_cpu:
            np.testing.assert_array_equal(on_card[k].cpu().numpy(), on_cpu[k].numpy(), err_msg=k)
