"""The frozen work counts against counts made by hand."""

import pytest

from perfbench import work

BLOCKS = ((160, 64, 128), (80, 128, 256), (40, 256, 512))  # (H, Cin, Cout) at patch 320


def test_block_work_of_a_forward():
    flops = sum(work.block_work(200, h, c, f)["flops"] for h, c, f in BLOCKS)
    nbytes = sum(work.block_work(200, h, c, f)["bytes"] for h, c, f in BLOCKS)
    assert flops == pytest.approx(851.4e9, rel=1e-4)
    assert nbytes == pytest.approx(1.722e9, rel=1e-3)
    # block 1 bound by bytes, blocks 2-3 by operations (PERF.md's kernel table)
    b1, b2, b3 = (work.block_work(200, h, c, f) for h, c, f in BLOCKS)
    assert b1["bytes_s"] > b1["ops_s"] and b2["ops_s"] > b2["bytes_s"] and b3["ops_s"] > b3["bytes_s"]
    assert b1["bound_s"] + b2["bound_s"] + b3["bound_s"] == pytest.approx(0.845e-3, rel=2e-3)


def test_unet_forward_by_hand():
    # one patch, by hand: entry 3x3/2 1->64 at 160^2
    layers = dict(work.unet_layers(320, (64, 128, 256, 512)))
    assert layers["entry"] == 2 * 160 * 160 * 9 * 64
    assert layers["down0.pw1"] == 2 * 160 * 160 * 64 * 128
    assert layers["up0.conv1"] == 2 * 20 * 20 * 9 * 512 * 512
    assert layers["up3.res"] == 2 * 160 * 160 * 128 * 64
    assert layers["head"] == 2 * 320 * 320 * 9 * 64
    # the down blocks' part equals block_work's count
    down = sum(v for k, v in layers.items() if k.startswith("down"))
    assert down * 200 == sum(work.block_work(200, h, c, f)["flops"] for h, c, f in BLOCKS)
    assert work.unet_flops(320, (64, 128, 256, 512)) * 200 == pytest.approx(5.327e12, rel=1e-3)


def test_resnet50_to_conv4_by_hand():
    layers = dict(work.resnet50_layers(256, "conv4_block6_out"))
    assert layers["conv1"] == 2 * 128 * 128 * 49 * 3 * 64
    assert layers["conv2_block1.0"] == 2 * 64 * 64 * 64 * 256
    assert layers["conv3_block1.1"] == 2 * 32 * 32 * 256 * 128  # the stride on the first 1x1
    assert layers["conv4_block6.2"] == 2 * 16 * 16 * 9 * 256 * 256
    assert "conv5_block1.1" not in layers and layers["head"] == 2 * 1024
    # 8 slices x 3 members a stack
    assert 24 * work.resnet50_flops(256, "conv4_block6_out") == pytest.approx(195.9e9, rel=1e-3)


def test_focus_work_and_union():
    w = work.focus_work([8], 1024, 1024, 1)
    assert w["flops"] == 8 * 1024 * 1024 * 53 and w["bytes"] == 9 * 1024 * 1024 + 4
    assert w["bound_s"] * 1e3 == pytest.approx(0.00664, rel=1e-2)
    assert work.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert work.union_s([]) == 0
