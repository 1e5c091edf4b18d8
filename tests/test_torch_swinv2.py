"""The SwinV2 invasion classifier (``tmat_torch/models/swin.py``) against the
benchmark's plain reference (``perfbench/reference/swinv2.py``), on the CPU.

A tiny member: 64² input, embed 32, depths 2-2-2-2, heads 1-2-4-8, window 4,
so that stages 0-1 (grids 16 and 8) shift their odd blocks, stage 2 (grid
4) does not, and stage 3 (grid 2) clamps its window to 2. Its seeded
weights are moved off the published init where the init would hide a
part (a near-constant position bias, one temperature, LayerNorm (1, 0),
zero biases), so that every part shows in the logits.

Tolerances: float32 logits within 1e-4 (the two sum in other orders; they
agree to ~1e-7). In bfloat16, whose rounding unit is 2^-8 ≈ 0.39%, each of
the eight blocks' products and normalisations rounds its output once or
twice, so the logits carry a few units of relative error: within 2% of
the largest logit (~20 here; measured 0.49%), where the reference with
every Linear in float8 is off by 9%. Each planted fault moves the float32
logits by more than 1e-2, a hundred times the tolerance.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tmat_torch.core import defs
from tmat_torch.models import swin
from tmat_torch.models.preprocess import imagenet_prep_tail
from tmat_torch.tools import compute_inv_depth as tool

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench.reference import swinv2 as ref  # noqa: E402

ARCH = {"patch": 4, "embed_dim": 32, "depths": (2, 2, 2, 2), "heads": (1, 2, 4, 8), "window": 4,
        "mlp_ratio": 4, "cpb_hidden": 64}
SIZE = 64
WINDOWS_PER_IMAGE = 2 * 16 + 2 * 4 + 2 * 1 + 2 * 1  # per stage: blocks x (grid / window)²


def _member(seed: int) -> swin.SwinV2TL:
    """A tiny float32 member on the CPU, every part of it away from the init."""
    m = swin.build_swinv2_tl((SIZE, SIZE, 3), ARCH, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in m.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if "cpb_mlp" in name:
                p.copy_(noise * 0.5)
            elif "logit_scale" in name:
                p.copy_(torch.rand(p.shape, generator=g) * 5)  # scales 1 to 100 (clamped)
            elif "norm" in name or name.endswith("bias"):
                p.add_(noise * 0.1)
            elif name == "head.weight":
                p.copy_(noise)
    return m.prepare()


@pytest.fixture(scope="module")
def member():
    m = _member(1)
    return m, ref.SwinV2Ref(m.state_dict(), SIZE, ARCH, "cpu")


@pytest.fixture(scope="module")
def images():
    return torch.randn(4, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(0))


def test_port_matches_the_reference_in_float32(member, images):
    m, r = member
    got, want = m.logits(images)[:, 0], r(images)
    assert want.std() > 0.1  # the logits spread: the comparison means something
    assert (got - want).abs().max().item() < 1e-4
    assert torch.allclose(m(images)[:, 0], torch.sigmoid(want), atol=1e-5)


def test_port_in_bfloat16_matches_the_reference(member, images, tmp_path):
    m, r = member
    swin.save_member(m, tmp_path / "m.pt")
    m16 = swin.load_member(tmp_path / "m.pt", (SIZE, SIZE, 3), torch.bfloat16, "cpu")
    assert m16.dtype == torch.bfloat16 and m16.head.weight.dtype == torch.float32
    want = r(images)
    tol = 0.02 * want.abs().max().item()
    assert (m16.logits(images)[:, 0] - want).abs().max().item() < tol
    # one precision lower does not pass
    fp8 = ref.SwinV2Ref(m.state_dict(), SIZE, ARCH, "cpu", quantize=True)
    assert (fp8(images) - want).abs().max().item() > tol


def _no_shift(m):
    for blk in m.blocks():
        if blk.shift:
            grid = int(blk.order.numel() ** 0.5)
            blk.order = swin.window_order(grid, blk.window, 0)
            blk.unorder = torch.argsort(blk.order)
            blk.attn.shift_mask = None
            blk.attn.bias = blk.attn.bias[:1]
            blk.attn.prepare()


def _no_cpb(m):
    for blk in m.blocks():
        mask = blk.attn.shift_mask
        blk.attn.bias = (torch.zeros_like(blk.attn.bias) if mask is None
                         else mask[:, None].expand_as(blk.attn.bias).clone())


def _dot_product(monkeypatch):
    def plain(q, k, v, bias, mask, scale):
        logits = q @ k.transpose(-2, -1) * scale.view(-1, 1, 1)
        n_w = bias.shape[0]
        logits = logits.view(-1, n_w, *logits.shape[1:]) + bias[None]
        return torch.softmax(logits, dim=-1).view(q.shape[0], -1, q.shape[2], q.shape[2]) @ v

    monkeypatch.setattr(swin, "window_attention", plain)


def _pre_norm(monkeypatch):
    def forward(self, x):
        b, l, c = x.shape
        y = torch.index_select(self.norm1(x), 1, self.order).view(-1, self.window * self.window, c)
        x = x + torch.index_select(self.attn(y).view(b, l, c), 1, self.unorder)
        return x + self.mlp(self.norm2(x))

    monkeypatch.setattr(swin.SwinBlock, "forward", forward)


def _norm_first(monkeypatch):
    def forward(self, x):
        b, _, c = x.shape
        x = x.view(b, self.grid // 2, 2, self.grid // 2, 2, c)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        x = torch.nn.functional.layer_norm(x.view(b, -1, 4 * c), (4 * c,), eps=swin.LN_EPS)
        return self.norm(self.reduction(x))

    monkeypatch.setattr(swin.PatchMerging, "forward", forward)


@pytest.mark.parametrize("fault", ["no_shift", "no_cpb_bias", "dot_product", "pre_norm", "merge_norm_first"])
def test_planted_faults_fail_the_float32_comparison(monkeypatch, member, images, fault):
    _, r = member
    m = _member(1)  # a fresh copy to break
    if fault == "no_shift":
        _no_shift(m)
    elif fault == "no_cpb_bias":
        _no_cpb(m)
    elif fault == "dot_product":
        _dot_product(monkeypatch)
    elif fault == "pre_norm":
        _pre_norm(monkeypatch)
    else:
        _norm_first(monkeypatch)
    assert (m.logits(images)[:, 0] - r(images)).abs().max().item() > 1e-2


@pytest.mark.parametrize("grid,window,shift", [(16, 4, 2), (8, 4, 2), (64, 16, 8), (32, 16, 8)])
def test_shift_mask_and_window_order_match_the_reference(grid, window, shift):
    assert torch.equal(swin.shift_mask(grid, window, shift), ref.shift_mask(grid, window, shift))
    x = torch.arange(grid * grid * 2.0).view(1, grid, grid, 2)
    rolled = ref.window_partition(torch.roll(x, (-shift, -shift), (1, 2)), window).reshape(-1, 2)
    assert torch.equal(x.view(-1, 2)[swin.window_order(grid, window, shift)], rolled)
    assert torch.equal(swin.relative_position_index(window), ref.position_index(window))


def test_window_attention_takes_the_mask_apart_or_summed(member):
    m, _ = member
    blk = m.blocks()[1]  # shifted: 16 windows
    attn = blk.attn
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2 * 16, 1, 16, 32, generator=g) for _ in range(3))
    summed = swin.window_attention(q, k, v, attn.bias, None, attn.scale)
    apart = swin.window_attention(q, k, v, attn.bias - attn.shift_mask[:, None], attn.shift_mask, attn.scale)
    assert torch.allclose(summed, apart, atol=1e-5)


def test_tables_suit_the_fused_attention_kernels(member):
    """The fused kernels take ``attn_mask`` only with a unit last stride
    (else PyTorch falls back to its math path on the card)."""
    m, _ = member
    for blk in m.blocks():
        windows = blk.order.numel() // blk.window**2
        assert blk.attn.bias.is_contiguous() and blk.attn.bias.shape[0] == (windows if blk.shift else 1)


def test_prepare_writes_the_tables_in_place():
    """A captured graph reads the tables where it found them: ``prepare``
    after a change of weights rewrites them there."""
    m = _member(3)
    attn = m.blocks()[1].attn
    tables = (attn.bias, attn.scale, attn.qkv_bias)
    before = [t.clone() for t in tables]
    with torch.no_grad():
        attn.cpb_mlp[2].weight.mul_(2)
        attn.logit_scale.sub_(0.5)
        attn.q_bias.add_(1)
    m.prepare()
    assert all(t is u for t, u in zip(tables, (attn.bias, attn.scale, attn.qkv_bias)))
    assert all(not torch.equal(t, b) for t, b in zip(tables, before))
    assert m._graph is None  # nothing captured off the card


def test_checkpoint_round_trip_through_load_ensemble(member, images, tmp_path):
    m, _ = member
    paths = [tmp_path / "a.pt", tmp_path / "b.pt"]
    for p in paths:
        swin.save_member(m, p)
    ens = tool.load_ensemble(paths, (SIZE, SIZE, 3), None, torch.float32, "cpu", backbone=swin.BACKBONE)
    assert [type(e) for e in ens] == [swin.SwinV2TL] * 2
    assert swin.arch_of(torch.load(paths[0], weights_only=True)) == {**ARCH, "n_outputs": 1}
    assert torch.equal(ens[1].logits(images), m.logits(images))
    with pytest.raises(ValueError, match="backbone"):
        tool.load_ensemble(paths, (SIZE, SIZE, 3), None, torch.float32, "cpu", backbone="vit")


def test_imagenet_prep_tail_matches_the_reference():
    from perfbench.reference.resnet import lanczos4_weights

    stack = np.random.RandomState(4).randint(0, 255, (2, 80, 80)).astype(np.uint8)
    wh = lanczos4_weights(80, SIZE)
    resized = np.clip(np.rint(wh @ stack.astype(np.float64) @ wh.T), 0, 255).astype(np.uint8)
    got = imagenet_prep_tail(torch.from_numpy(resized))
    assert got.shape == (2, SIZE, SIZE, 3)
    assert (got.double() - ref.prep(stack, (SIZE, SIZE), "cpu").double()).abs().max().item() < 1e-5


@pytest.fixture(scope="module")
def ensemble():
    return [_member(1), _member(2)]


def test_predict_rows_end_to_end_against_the_reference(ensemble):
    rng = np.random.RandomState(5)
    stacks = [(f"S{i}", rng.randint(0, 255, (3, 96, 96)).astype(np.uint8)) for i in range(2)]
    rows = tool.predict_rows(stacks, ensemble, (SIZE, SIZE), 0.5)
    members = [ref.SwinV2Ref(m.state_dict(), SIZE, ARCH, "cpu") for m in ensemble]
    want = []
    for _, stack in stacks:
        want += ref.rows(torch.sigmoid(ref.stack_logits(stack, members, (SIZE, SIZE), "cpu")), 0.5)
    assert [r[tool.ID_COL] for r in rows] == [f"S{i}_z{z}" for i in range(2) for z in range(3)]
    got = np.array([r[tool.PROB_COL] for r in rows])
    np.testing.assert_allclose(got, [p for p, _ in want], atol=1.5e-4, rtol=0)
    assert len(set(got.tolist())) > 1


def test_main_takes_the_backbone_from_the_hp_file(tmp_path, monkeypatch, ensemble):
    mt = tmp_path / "model_training"
    (mt / "best_ensemble").mkdir(parents=True)
    (mt / "invasion_depth_best_hp.json").write_text(json.dumps({"backbone": swin.BACKBONE}))
    (mt / "invasion_depth_training_values.json").write_text(
        json.dumps({"cls_thresh": 0.5, "resnet_inp_shape": [SIZE, SIZE, 3], "n_models": 2}))
    for i, m in enumerate(ensemble):
        swin.save_member(m, mt / "best_ensemble" / f"best_finetune_weights_{i}.pt")
    monkeypatch.setattr(defs, "MODEL_TRAINING_DIR", mt)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"n_pred_models": 2}))
    stack = np.random.RandomState(6).randint(0, 255, (2, 72, 72)).astype(np.uint8)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    from PIL import Image

    frames = [Image.fromarray(s) for s in stack]
    frames[0].save(in_dir / "w.tif", save_all=True, append_images=frames[1:])
    tool.main(argv=[str(in_dir), str(tmp_path / "out"), "-c", str(cfg)], device="cpu")
    with open(tmp_path / "out" / "invasion_depth_predictions.csv") as f:
        csv_probs = [float(line.split(",")[1]) for line in f.read().splitlines()[1:]]
    want = tool.stack_rows("w", tool.predict_stack(stack, ensemble, (SIZE, SIZE)), 0.5)
    assert csv_probs == [r[tool.PROB_COL] for r in want]
    # an unknown backbone stops the tool
    (mt / "invasion_depth_best_hp.json").write_text(json.dumps({"backbone": "vit"}))
    with pytest.raises(SystemExit):
        tool.main(argv=[str(in_dir), str(tmp_path / "out2"), "-c", str(cfg)], device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph replay and the fused attention run only on the card")
    return torch.device("cuda", 0)


def padded_features(member, chunk):
    """The eager features of ``chunk``'s rows, run padded with zeros to the graph's batch."""
    pad = chunk.new_zeros(swin.GRAPH_BATCH - len(chunk), *chunk.shape[1:])
    return member.features(torch.cat([chunk, pad]))[:len(chunk)]


@pytest.mark.gpu
def test_graph_replay_equals_the_eager_features_on_the_card(cuda, tmp_path):
    """A loaded member replays its features from the one CUDA graph of
    ``GRAPH_BATCH`` slices captured at load: a batch of any size takes
    ``ceil(B / GRAPH_BATCH)`` replays, each row as the eager features of
    its chunk padded to the graph's batch, and no new capture."""
    m = _member(1)
    swin.save_member(m, tmp_path / "m.pt")
    card = swin.load_member(tmp_path / "m.pt", (SIZE, SIZE, 3), torch.bfloat16, cuda)
    graph, n = card._graph, swin.GRAPH_BATCH
    assert graph is not None and graph[1].shape == (n, SIZE, SIZE, 3)
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for b in (4, 1, n, 2 * n + 3):
            x = torch.randn(b, SIZE, SIZE, 3, device=cuda, generator=g)
            eager = torch.cat([padded_features(card, x[i:i + n]) for i in range(0, b, n)])
            replayed = card._replayed(x).clone()
            assert replayed.shape == eager.shape == (b, card.out_channels)
            assert (replayed - eager).abs().max().item() <= 1e-3 * eager.abs().max().item()
    assert card._graph is graph


@pytest.mark.gpu
def test_predict_rows_takes_stacks_of_two_depths_on_the_card(cuda, ensemble, tmp_path):
    """Stacks of 3 and 11 slices (one replay padded, then two) through
    ``predict_rows`` with members loaded on the card in float32, TF32 off,
    against the same members run eagerly on the card and on the CPU; the
    graphs captured at load serve both depths."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    paths = [tmp_path / f"m{i}.pt" for i in range(len(ensemble))]
    for m, p in zip(ensemble, paths):
        swin.save_member(m, p)
    card = tool.load_ensemble(paths, (SIZE, SIZE, 3), None, torch.float32, cuda, backbone=swin.BACKBONE)
    eager = tool.load_ensemble(paths, (SIZE, SIZE, 3), None, torch.float32, cuda, backbone=swin.BACKBONE)
    for m in eager:
        m._graph = None
    graphs = [m._graph for m in card]
    rng = np.random.RandomState(7)
    stacks = [(f"S{z}", rng.randint(0, 255, (z, 96, 96)).astype(np.uint8)) for z in (3, 11, 3)]
    got = tool.predict_rows(stacks, card, (SIZE, SIZE), 0.5)
    want = tool.predict_rows(stacks, eager, (SIZE, SIZE), 0.5)
    assert [r[tool.ID_COL] for r in got] == [r[tool.ID_COL] for r in want]
    host = tool.predict_rows(stacks, ensemble, (SIZE, SIZE), 0.5)
    for other in (want, host):
        np.testing.assert_allclose([r[tool.PROB_COL] for r in got], [r[tool.PROB_COL] for r in other],
                                   atol=1.5e-4, rtol=0)
    assert len({r[tool.PROB_COL] for r in got}) > 1
    assert all(m._graph is g for m, g in zip(card, graphs)) and all(g is not None for g in graphs)


@pytest.mark.gpu
def test_the_fused_attention_kernel_runs_on_the_card(cuda):
    """The bias tables reach SDPA's fused kernels (not its math path) and a
    forward counts its blocks and windows."""
    from torch.profiler import ProfilerActivity, profile

    from tmat_torch.core.profiling import StageTimer, recorded_spans, traced

    member = swin.build_swinv2_tl((SIZE, SIZE, 3), ARCH, torch.bfloat16, 1, cuda).capture()
    x = torch.randn(2, SIZE, SIZE, 3, device=cuda)
    with torch.no_grad():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with traced(True, "S0"), StageTimer().stage("swin_forward"):
                member(x)
            torch.cuda.synchronize()
    names = [e.key.lower() for e in prof.key_averages()]
    assert any(k in n for n in names for k in ("sdpa", "fmha", "flash_fwd")), names
    mine = [s for s in recorded_spans() if s.item == "S0"]
    # a replay runs the graph's GRAPH_BATCH images
    assert mine[-1].counts == {"attn_calls": 8, "attn_windows": swin.GRAPH_BATCH * WINDOWS_PER_IMAGE}
