"""Evaluate a trained patch segmentor on a directory of images.

Counterpart of ``tmat_tpu/models/eval_segmentation.py``: loads the
segmentor from a numbered config (the latest by default), predicts each
image through the tiled pipeline (the down-block kernel on CUDA), saves
image / prediction / threshold (/ ground truth) panels, and reports the
mean IoU at 0.5 where ``*_mask`` files are present. ``evaluate`` is the
loop without the panels (no matplotlib), for callers that want the IoUs.

Usage:
    python -m tmat_torch.models.eval_segmentation IMG_DIR OUT_DIR
        [--model-cfg PATH] [--mask-suffix _mask.tif]
"""

from __future__ import annotations

import argparse
from glob import glob
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from tmat_torch.core import defs, io as tio
from tmat_torch.device import DeviceLike
from tmat_torch.models.registry import get_last_exp_num
from tmat_torch.models.unet import get_unet_patch_segmentor_from_cfg


def image_paths(img_dir: str, img_suffix: str = ".tif", mask_suffix: str = "_mask.tif") -> List[str]:
    """The images of ``img_dir`` (the masks left out), sorted."""
    paths = sorted(fp for fp in glob(str(Path(img_dir) / f"*{img_suffix}"))
                   if not fp.endswith(mask_suffix))
    if not paths:
        raise FileNotFoundError(f"No images in {img_dir}")
    return paths


def evaluate(segmentor, img_paths, img_suffix: str = ".tif", mask_suffix: str = "_mask.tif",
             on_image: Optional[Callable] = None) -> List[float]:
    """Segment each image (a stack's max projection); the smooth IoU
    (intersection + 1) / (union + 1) of the prediction > 0.5 against each
    image that has a mask. ``on_image(path, img, pred, thresh, mask)`` sees
    every image (``mask`` None without one)."""
    ious = []
    for fp in img_paths:
        img, _ = tio.load_image(fp)
        if img.ndim == 3:
            img = img.max(0)
        pred = segmentor.predict(np.asarray(img, np.float32))
        thresh = pred > 0.5
        mask_path = fp.replace(img_suffix, mask_suffix)
        mask = None
        if Path(mask_path).is_file():
            mask = np.asarray(tio.load_image(mask_path)[0]) > 0
            inter = (thresh & mask).sum()
            union = (thresh | mask).sum()
            ious.append((inter + 1) / (union + 1))
        if on_image is not None:
            on_image(fp, img, pred, thresh, mask)
    return ious


def main(argv=None, device: DeviceLike = None) -> List[float]:
    """Evaluate and draw the panels; returns the IoUs."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("img_dir", type=str)
    p.add_argument("out_dir", type=str)
    p.add_argument("--model-cfg", type=str, default=None)
    p.add_argument("--mask-suffix", type=str, default="_mask.tif")
    p.add_argument("--img-suffix", type=str, default=".tif")
    args = p.parse_args(argv)

    model_cfg = args.model_cfg
    if not model_cfg:
        cfg_dir = Path(defs.model_training_path("binary_segmentation")) / "configs"
        model_cfg = str(cfg_dir / f"unet_patch_segmentor_{get_last_exp_num()}.json")
    segmentor = get_unet_patch_segmentor_from_cfg(model_cfg, device=device)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = image_paths(args.img_dir, args.img_suffix, args.mask_suffix)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def panels(fp, img, pred, thresh, mask):
        n_panels = 3 + (mask is not None)
        fig, axes = plt.subplots(1, n_panels, figsize=(4 * n_panels, 4))
        for ax, (panel, title) in zip(
            axes,
            [(img, "image"), (pred, "prediction"), (thresh, "threshold 0.5")]
            + ([(mask, "ground truth")] if mask is not None else []),
        ):
            ax.imshow(panel, cmap="gray")
            ax.set_title(title)
            ax.set_axis_off()
        panel_path = out_dir / f"{Path(fp).stem}_eval.png"
        fig.savefig(panel_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"{Path(fp).name} -> {panel_path}", flush=True)

    ious = evaluate(segmentor, paths, args.img_suffix, args.mask_suffix, panels)
    if ious:
        print(f"mean IoU @0.5 over {len(ious)} images: {np.mean(ious):.4f}", flush=True)
    return ious


if __name__ == "__main__":
    main()
