"""Reconstruction visualization, ``--test`` on a pretrain config (port of
``point_dae_tpu/engine/visualization.py``; reference tools/runner.py:14-113
and Corruption_visualization.py): each test sample's ground truth, first
output (the coarse cloud, or the visible patches) and rebuilt cloud from
the model's ``reconstruct``, rendered by the native ball rasterizer, with
the raw arrays in an ``.npz``.

A render is saved as a PNG through ``matplotlib`` and as ``<name>.png.npy``
(the (H, W, 3) float image) where ``matplotlib`` is missing, as in the JAX
package.
"""
from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from ..data.native_io import render_balls
from ..parallel.mesh import get_mesh
from ..utils.device import resolve_device
from ..utils.logger import print_log


def _save_png(path: str, img: np.ndarray) -> None:
    if not get_mesh().is_main:           # under a process group rank 0 writes
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(path, np.clip(img, 0, 1))
    except Exception:
        np.save(path + ".npy", img)


def _rotate_for_view(pts: np.ndarray) -> np.ndarray:
    """A fixed isometric-like view."""
    a, b = np.radians(30), np.radians(-45)
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    return pts @ (ry @ rx)


def render_cloud(pts: np.ndarray, color=(0.4, 0.7, 1.0), size: int = 480) -> np.ndarray:
    """(N, 3) -> (size, size, 3) image of the cloud centred, scaled into the
    unit sphere and turned to the fixed view."""
    pts = np.asarray(pts, np.float32)
    pts = pts - pts.mean(0)
    pts = pts / max(np.linalg.norm(pts, axis=1).max(), 1e-6)
    pts = _rotate_for_view(pts)
    colors = np.tile(np.asarray(color, np.float32)[None], (pts.shape[0], 1))
    return render_balls(pts, colors, h=size, w=size, radius=4.0)


def test_vis_reconstruction(config, args, logger_name: str = "PointDAE",
                            max_samples: int = 16, device=None) -> str:
    """Run the model's ``reconstruct`` in eval mode over the test split (or
    val, or train) in batches of 4 and save ``max_samples`` samples'
    renders and arrays to ``<experiment>/vis``, named by taxonomy and model
    id. A model without ``reconstruct`` raises AttributeError. Returns the
    directory."""
    from ..data.datasets import build_dataset_from_cfg
    from ..data.loader import DataLoader
    from ..models import build_model_from_cfg
    from ..utils.checkpoint import load_params, merge_pretrained

    dev = resolve_device(device)
    seed = int(getattr(args, "seed", 0))
    dcfg = config["dataset"]
    split = dcfg.get("test", dcfg.get("val", dcfg["train"]))
    dataset = build_dataset_from_cfg(split["_base_"], split["others"], device=dev)
    model = build_model_from_cfg(config["model"], device=dev, seed=seed)
    reconstruct = model.reconstruct
    npoints = int(config.get("npoints", 1024))
    out_dir = os.path.join(args.experiment_path, "vis")
    os.makedirs(out_dir, exist_ok=True)
    it = iter(DataLoader(dataset, 4, shuffle=False, drop_last=True))
    try:
        first = next(it)
    except StopIteration:
        print_log(f"[Vis] split has no full batch - saved 0 samples to {out_dir}",
                  logger=logger_name)
        return out_dir
    # token_dis decodes through the tokenizer's decoder, which its training
    # path does not build
    if hasattr(model, "build_reconstruct"):
        model.build_reconstruct(torch.Generator().manual_seed(seed))
    if getattr(args, "ckpts", None):
        merge_pretrained(model, load_params(args.ckpts, args.ckpts), logger=logger_name)
    model.eval()
    generator = torch.Generator(device=dev).manual_seed(seed)
    done = 0
    for batch in itertools.chain([first], it):
        pts_all = torch.from_numpy(np.asarray(batch["points"][:, :npoints], np.float32)).to(dev)
        pts = pts_all[..., :3].cpu().numpy()
        with torch.no_grad():
            out = reconstruct(pts_all, generator=generator)
        if isinstance(out, (tuple, list)):
            coarse, rebuild = out[0], out[1]
        else:
            coarse = rebuild = out        # one output (Point_CAE_DGCNN_FCOnly's FC cloud)
        coarse = coarse.float().cpu().numpy()
        rebuild = rebuild.float().cpu().numpy().reshape(pts.shape[0], -1, 3)
        for b in range(pts.shape[0]):
            tid = batch["taxonomy_id"][b] if "taxonomy_id" in batch else "x"
            mid = batch["model_id"][b] if "model_id" in batch else str(done)
            stem = os.path.join(out_dir, f"{tid}_{mid}")
            _save_png(stem + "_gt.png", render_cloud(pts[b]))
            _save_png(stem + "_coarse.png", render_cloud(coarse[b], color=(1.0, 0.6, 0.3)))
            _save_png(stem + "_rebuild.png", render_cloud(rebuild[b], color=(0.5, 1.0, 0.5)))
            if get_mesh().is_main:
                np.savez(stem + ".npz", gt=pts[b], coarse=coarse[b], rebuild=rebuild[b])
            done += 1
            if done >= max_samples:
                print_log(f"[Vis] saved {done} samples to {out_dir}", logger=logger_name)
                return out_dir
    print_log(f"[Vis] saved {done} samples to {out_dir}", logger=logger_name)
    return out_dir


def visualize_corruptions(out_dir: str, types=("affine_r3", "dropout_local", "add_global",
                                               "add_local", "jitter", "nonuniform_density"),
                          npoints: int = 1024, seed: int = 0, device=None) -> str:
    """Corruption_visualization.py: render a Synthetic cloud clean and under
    each corruption of ``types`` (each resampled to ``npoints``). The cloud
    is corrupted and resampled on ``device`` and moved to the host only to
    be rendered."""
    from ..data import corruptions as C
    from ..data.datasets import Synthetic
    from ..ops.geometry import resample_batch

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    ds = Synthetic({"size": 1, "N_POINTS": 2048, "with_normal": False})
    pts = torch.from_numpy(np.asarray(ds[0]["points"][:, :3], np.float32))[None].to(dev)
    _save_png(os.path.join(out_dir, "clean.png"), render_cloud(pts[0].cpu().numpy()))
    for i, t in enumerate(types):
        g = torch.Generator(device=dev).manual_seed(seed + i)
        out, mask = C.corrupt_batch(pts, (t,), generator=g)
        out = resample_batch(out, mask, npoints, generator=g)
        _save_png(os.path.join(out_dir, f"{t}.png"),
                  render_cloud(out[0].cpu().numpy(), color=(1.0, 0.5, 0.4)))
    return out_dir
