"""The port's CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device (``gpu`` marker) and skip without one. The
kernel has no CPU or interpret mode; the CPU tests hold the plain version
against the JAX package instead. The file imports no JAX, so on the card
it runs without the suite's JAX conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -p no:cacheprovider -q
"""

import numpy as np
import pytest
import torch

from tmat_torch.models.unet import UNetXception
from tmat_torch.ops import down_block as db

# (batch, H, C, F): the test suite's block shapes, odd channel counts, and
# the three production blocks (patch 320, filters 64-512)
SHAPES = [(2, 16, 8, 16), (2, 16, 4, 8), (2, 8, 8, 16), (3, 10, 5, 12), (2, 32, 64, 128),
          (2, 16, 128, 256), (2, 8, 256, 512), (2, 160, 64, 128), (2, 80, 128, 256),
          (2, 40, 256, 512)]


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
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype, first):
    """f32: atol 2e-5. bf16: another summation order can move a rounding
    of t or u by one bf16 step, so within 2**-6 of the largest output."""
    b, h, c, f = shape
    x, blk = db.random_block(np.random.RandomState(0), b, h, c, f, dtype, cuda)
    before = db.launches
    out = db.down_block(x, blk, first)
    torch.cuda.synchronize()
    assert db.launches == before + 1
    ref = db.down_block_plain(x, blk, first)
    assert out.shape == ref.shape and out.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_launch_configurations(cuda):
    """The production blocks stage their x tile; a block too wide for that
    reads x from global memory; one that fits nowhere is refused."""
    assert [db.launch_config(c, f, torch.bfloat16) for _, _, c, f in SHAPES[-3:]] == [
        (8, True), (4, True), (4, True)]
    assert db.launch_config(512, 1024, torch.bfloat16) == (2, False)
    with pytest.raises(ValueError, match="no down-block launch fits"):
        db.launch_config(512, 1024, torch.float32)
    x, blk = db.random_block(np.random.RandomState(3), 1, 4, 512, 1024, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        db.down_block(x, blk, True)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_unaligned_tensors(cuda, dtype):
    """Contiguous views that start off a 16-byte boundary take the kernel's
    element-wise loads instead of its vector loads; same result."""
    x, blk = db.random_block(np.random.RandomState(2), 2, 16, 64, 128, dtype, cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    out = db.down_block(shifted(x), {k: shifted(v) for k, v in blk.items()}, False)
    ref = db.down_block(x, blk, False)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.gpu
def test_wrapper_refuses_mixed_devices(cuda):
    x, blk = db.random_block(np.random.RandomState(0), 1, 8, 8, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="w1"):
        db.down_block(x, dict(blk, w1=blk["w1"].cpu()), True)


@pytest.mark.gpu
def test_unet_forward_goes_through_the_kernel(cuda):
    rng = np.random.RandomState(1)
    filters = (8, 16, 32)

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
    folded = {"entry": {"k": arr(3, 3, 1, filters[0], scale=1 / 3), "b": arr(filters[0], scale=0.1)},
              "down": down, "up": ups, "head": {"k": arr(3, 3, filters[0], 1, scale=0.1), "b": arr(1)}}
    net = UNetXception(folded, torch.bfloat16).to(cuda)
    batch = torch.tensor(rng.rand(4, 64, 64, 1).astype(np.float32), device=cuda)
    before = db.launches
    out = net(batch)
    torch.cuda.synchronize()
    assert db.launches == before + len(filters) - 1
    ref = net(batch, plain_down=True)
    assert torch.isfinite(out).all() and out.shape == (4, 64, 64, 1)
    assert (out - ref).abs().max().item() < 0.05
