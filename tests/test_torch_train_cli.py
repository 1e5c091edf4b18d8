"""The port's trainers end to end on the CPU against the JAX package's.

``train_segmentation.main`` and ``train_invasion.main`` with
``device="cpu"`` register models that both packages load and run (the
segmentor's probabilities within 1e-4); a tiny 20-step segmentation run
in both packages from the same initial variables and batches ends at
validation IoUs within 0.02 of each other, its epoch losses within 2%.
"""

import csv
import json

import numpy as np
import pytest
import torch
from PIL import Image

from tmat_tpu.core import defs as jdefs
from tmat_torch.core import defs


@pytest.fixture
def model_dirs(tmp_path, monkeypatch):
    mt = tmp_path / "model_training"
    monkeypatch.setattr(defs, "MODEL_TRAINING_DIR", mt)
    monkeypatch.setattr(jdefs, "MODEL_TRAINING_DIR", mt)
    return mt


def _seg_data(d, n=10, hw=32, seed=0):
    d.mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = (rng.rand(hw, hw) * 40).astype(np.uint8)
        mask = np.zeros((hw, hw), np.uint8)
        c = 6 + (i % 5) * 3
        mask[4:28, c:c + 5] = 255
        mask[c:c + 4, 4:28] = 255
        img[mask > 0] = 200
        Image.fromarray(img).save(d / f"s{i}.tif")
        Image.fromarray(mask).save(d / f"s{i}_mask.tif")
    return d


def test_train_segmentation_registers_a_model_both_packages_load(tmp_path, model_dirs, capsys):
    from tmat_tpu.models.unet import get_unet_patch_segmentor_from_cfg as jax_segmentor
    from tmat_torch.models import train_segmentation
    from tmat_torch.models.unet import get_unet_patch_segmentor_from_cfg

    data = _seg_data(tmp_path / "seg", n=4)
    cfg_path = train_segmentation.main(
        [str(data), "--patch-size", "16", "--filters", "4", "8", "--epochs", "2", "--batch-size",
         "2", "--ds-ratio", "1.0", "--warmup-steps", "1"], device="cpu")
    cfgs = list((model_dirs / "binary_segmentation" / "configs").glob("*.json"))
    ckpts = list((model_dirs / "binary_segmentation" / "checkpoints").glob("*.msgpack"))
    assert cfgs == [cfg_path] and len(ckpts) == 1
    cfg = json.loads(cfg_path.read_text())
    assert cfg == {"patch_size": 16, "checkpoint_file": ckpts[0].name, "filter_counts": [4, 8],
                   "ds_ratio": 1.0, "channels": 1}
    assert "epoch 1:" in capsys.readouterr().out
    img = np.random.RandomState(0).rand(40, 40).astype(np.float32)
    port = get_unet_patch_segmentor_from_cfg(str(cfg_path), device="cpu").predict(img)
    ref = np.asarray(jax_segmentor(str(cfg_path)).predict(img))
    assert port.shape == ref.shape == (40, 40)
    np.testing.assert_allclose(port, ref, atol=1e-4, rtol=0)


def test_twenty_steps_follow_the_jax_curve(tmp_path):
    """20 AdamW steps (10 epochs of 2 augmented batches, warmup into cosine
    restarts) from the same initial variables in both packages: the epoch
    losses stay within 2% and the final validation IoUs within 0.02."""
    import jax
    import optax
    from tmat_tpu.models import train as JT
    from tmat_tpu.models.unet import UNetXception as JaxUNet
    from tmat_torch.models import train as T, train_segmentation as TS
    from tmat_torch.models.layers import load_flax_variables
    from tmat_torch.models.unet import build_unet_xception

    data = _seg_data(tmp_path / "seg", n=10)
    args = TS.parse_args([str(data), "--patch-size", "32", "--filters", "4", "8", "--epochs", "10",
                          "--batch-size", "4", "--warmup-steps", "2", "--lr", "1e-2",
                          "--fg-weight", "4"])
    train_seq, val_seq = TS.make_sequences(args, np.random.RandomState(args.seed))
    epochs = [list(train_seq) for _ in range(args.epochs)]
    val = list(val_seq)
    assert len(epochs[0]) == 2 and len(val) == 1

    model = JaxUNet(1, (4, 8), bn_momentum=args.bn_momentum)
    v = jax.tree.map(np.asarray, jax.jit(lambda k, d: model.init(k, d, train=False))(
        jax.random.PRNGKey(0), np.zeros((1, 32, 32, 1), np.float32)))
    net = load_flax_variables(build_unet_xception(1, (32, 32), filter_counts=(4, 8),
                                                  bn_momentum=args.bn_momentum, device="cpu"), v)

    def run(M, state, step, eval_step):
        it = iter(epochs)
        _, result, _ = M.fit(state, step, eval_step, lambda: next(it), lambda: val,
                             epochs=args.epochs, monitor="val_mean_iou_coef", mode="max")
        return result.history

    tsched = TS.make_schedule(args, 2)
    jsched = JT.warmup_schedule(2, JT.cosine_decay_restarts(1e-2, max(10 * 2 // 3, 1),
                                                            t_mul=1.0, m_mul=0.5))
    tx = T.adamw(tsched)
    port = run(T, T.init_train_state(net, tx), T.make_unet_train_step(tx), T.make_unet_eval_step())
    jtx = optax.adamw(jsched)
    ref = run(JT, JT.init_train_state(v, jtx), JT.make_unet_train_step(model, jtx),
              JT.make_unet_eval_step(model))
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=0.02)
    assert ref["val_mean_iou_coef"][-1] > 0.3, ref  # all background would score 0.11
    assert abs(port["val_mean_iou_coef"][-1] - ref["val_mean_iou_coef"][-1]) <= 0.02, (port, ref)


def test_train_invasion_writes_members_both_packages_load(tmp_path, model_dirs):
    from tmat_tpu.models.params_io import load_params
    from tmat_tpu.models.resnet import build_resnet50_tl as jax_resnet
    from tmat_torch.models.params_io import from_flax_resnet_variables, load_variables
    from tmat_torch.models.resnet import build_resnet50_tl, ensemble_forward, load_member
    from tmat_torch.models.synthetic import generate_invasion_dataset
    from tmat_torch.models import train_invasion

    generate_invasion_dataset(tmp_path / "inv", n_per_class=5, size=40, seed=0)
    out = train_invasion.main([str(tmp_path / "inv"), "--n-models", "2", "--frozen-epochs", "1",
                               "--fine-tune-epochs", "1", "--batch-size", "2", "--img-size", "32",
                               "--last-layer", "conv2_block3_out"], device="cpu")
    assert out == model_dirs / "best_ensemble"
    for m in range(2):
        ckpt = out / f"best_finetune_weights_{m}.msgpack"
        tree = load_variables(ckpt)
        with open(out / f"best_model_history_{m}.csv") as fp:
            rows = list(csv.DictReader(fp))
        assert [r["training_stage"] for r in rows] == ["frozen", "finetune"]
        assert all(float(r["val_loss"]) > 0 for r in rows)
        # float16 on disk (the default --ckpt-dtype), float32 when read
        assert b"float16" in ckpt.read_bytes() and b"float32" not in ckpt.read_bytes()
        _, template = jax_resnet(1, (32, 32, 3), base_last_layer="conv2_block3_out", init="zeros")
        jtree = load_params(ckpt, template)
        np.testing.assert_array_equal(np.asarray(jtree["params"]["head"]["kernel"]),
                                      tree["params"]["head"]["kernel"])
        member = load_member(build_resnet50_tl(1, (32, 32, 3), "conv2_block3_out", init="zeros",
                                               device="cpu"),
                             from_flax_resnet_variables(tree))
        probs = ensemble_forward([member], torch.randn(3, 32, 32, 3) * 30)
        assert probs.shape == (1, 3, 1) and torch.isfinite(probs).all()
        assert ((probs >= 0) & (probs <= 1)).all()


class _Built(Exception):
    """Raised by a patched builder once the trainer has built its model."""


@pytest.mark.parametrize("trainer", ["segmentation", "invasion"])
def test_trainers_start_from_the_jax_init_of_the_same_seed(tmp_path, model_dirs, monkeypatch, trainer):
    """Both packages' trainers from the same flags (``--seed 7``), nothing
    carried across: the variables each builds before its first step are
    the same, leaf for leaf, bit for bit."""
    import jax
    from tmat_torch.models.layers import flatten_tree, flax_variables

    built = {}

    def capture(module, name, key):
        original = getattr(module, name)

        def build(*a, **k):
            out = original(*a, **k)
            built[key] = (flax_variables(out) if key == "port"
                          else jax.tree.map(np.asarray, out[1]))
            raise _Built
        monkeypatch.setattr(module, name, build)

    if trainer == "segmentation":
        from tmat_tpu.models import train_segmentation as jtrain
        from tmat_torch.models import train_segmentation as ttrain

        capture(jtrain, "build_unet_xception", "jax")
        capture(ttrain, "build_unet_xception", "port")
        argv = [str(_seg_data(tmp_path / "seg", n=4)), "--patch-size", "16", "--filters", "4", "8",
                "--batch-size", "2", "--ds-ratio", "1.0", "--seed", "7"]
    else:
        from tmat_tpu.models import train_invasion as jtrain
        from tmat_torch.models import train_invasion as ttrain
        from tmat_torch.models.synthetic import generate_invasion_dataset

        capture(jtrain, "build_resnet50_tl", "jax")
        capture(ttrain, "build_trainable_resnet50_tl", "port")
        generate_invasion_dataset(tmp_path / "inv", n_per_class=4, size=40, seed=0)
        argv = [str(tmp_path / "inv"), "--n-models", "1", "--batch-size", "2", "--img-size", "32",
                "--last-layer", "conv2_block3_out", "--seed", "7"]
    with pytest.raises(_Built):
        jtrain.main(argv)
    with pytest.raises(_Built):
        ttrain.main(argv, device="cpu")
    port, ref = built["port"], built["jax"]
    for col in ("params", "batch_stats"):
        p, r = flatten_tree(port[col]), flatten_tree(dict(ref[col]))
        assert sorted(p) == sorted(r) and len(p) > 10
        for name in p:
            np.testing.assert_array_equal(p[name], r[name], err_msg=name)
