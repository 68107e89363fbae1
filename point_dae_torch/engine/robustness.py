"""Corruption-robustness evaluation, ``--test_corruption`` (port of
``point_dae_tpu/engine/robustness.py``; reference
tools/runner_finetune.py:637-683 and ``modelnetc_utils.eval_corrupt_wrapper``):
the overall accuracy of a classifier on the clean test set and under each
of the 7 ModelNet-C corruption families at 5 severity levels, aggregated
to mOA, mCE and RmCE against the official DGCNN table.

Two data paths, as in the JAX package:

1. the pre-generated ModelNet-C h5 files (``clean.h5`` and
   ``{corruption}_{level}.h5``, ``data`` and ``label``), fed to the model
   as they are: numbers comparable to the published benchmark. Reading them
   needs ``h5py``; where it is missing the reader raises and the run stops,
   it never falls back to generating the corruptions;
2. without such files, the corruptions generated on the device from the
   test set (severity tables of ``_corrupt_level``, every cell drawn from a
   generator seeded with ``seed``), each cloud FPS-sampled to ``npoints``:
   not comparable to the benchmark, and logged as such.

The masked families (dropouts, adds) resample every cloud back to its
point count from its valid points (``ops/geometry.py:resample_batch``: one
launch of the key gather kernel on the card). Random draws are inputs: a
``LevelDraws`` or a ``torch.Generator``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..data import corruptions as C
from ..data.corruptions_patch import _uniform
from ..ops.geometry import resample_batch
from ..parallel.mesh import sharded_eval
from ..utils.device import resolve_device
from ..utils.logger import print_log

CORRUPTIONS = ("scale", "jitter", "rotate", "dropout_global",
               "dropout_local", "add_global", "add_local")

# The official DGCNN mean error rates on ModelNet-C (the mCE = 1 anchor),
# from the reference's embedded eval log (run.sh:70-114): refER = meanER / CE.
DGCNN_REF_ER = {
    "clean": 0.074,
    "scale": 0.094, "jitter": 0.316, "rotate": 0.215,
    "dropout_global": 0.248, "dropout_local": 0.207,
    "add_global": 0.295, "add_local": 0.275,
}
SCALE_LEVELS = (1.6, 1.7, 1.8, 1.9, 2.0)
DROPOUT_RATES = (0.25, 0.375, 0.5, 0.625, 0.75)
MASKED = ("dropout_global", "dropout_local", "add_global", "add_local")


@dataclass
class LevelDraws:
    """The draws of one cell for a batch of n-point clouds: ``op`` the
    family's (scale factors (B, 3); jitter noise (B, n, 3); Euler angles
    (B, 3); dropout_global's uniforms (B, n); a ``DropoutLocalDraws``; the
    ball draws (B, n // 2, 3); an ``AddLocalDraws``) and, for the masked
    families, ``resample`` (B, n): uniforms or ranks into each cloud's valid
    points (``resample_batch``)."""
    op: Any
    resample: Optional[torch.Tensor] = None


def sample_level_draws(name: str, level: int, batch: int, n: int,
                       generator: Optional[torch.Generator], device) -> LevelDraws:
    """Draw one cell's randomness for a batch of n-point clouds."""
    if name == "scale":
        s = SCALE_LEVELS[level]
        op = _uniform((batch, 3), 1.0 / s, s, generator, device)
    elif name == "jitter":
        op = torch.randn((batch, n, 3), generator=generator, device=device)
    elif name == "rotate":
        op = C.sample_affine_param(f"rotate_level{level}", torch.zeros(batch, device=device),
                                   generator, device)
    elif name == "dropout_global":
        op = torch.rand((batch, n), generator=generator, device=device)
    elif name == "dropout_local":
        op = C.sample_dropout_local(batch, n, generator, device, drop_ratio=0.1 * (level + 1))
    elif name == "add_global":
        op = C.sample_ball_draws(batch, n // 2, generator, device)
    elif name == "add_local":
        op = C.sample_add_local(batch, n, n // 2, generator, device)
    else:
        raise NotImplementedError(name)
    resample = torch.rand((batch, n), generator=generator, device=device) \
        if name in MASKED else None
    return LevelDraws(op, resample)


def level_cloud(pts: torch.Tensor, name: str, level: int, draws: LevelDraws):
    """One cell's corruption before the resample: (points (B, n or n + n //
    2, 3), validity mask (B, rows) or None)."""
    B, n = pts.shape[:2]
    ones = torch.ones((B, n), dtype=torch.bool, device=pts.device)
    lv = torch.full((B,), float(level), device=pts.device)
    if name == "scale":
        return C.pc_normalize(pts * draws.op[:, None, :]), None
    if name == "jitter":
        return C.corrupt_jitter(pts, float(level), draws.op), None
    if name == "rotate":
        return C.rotate_points(pts, C.rotation_matrix("so3", draws.op)), None
    if name == "dropout_global":
        return pts, C.dropout_global_mask(ones, draws.op, DROPOUT_RATES[level])
    if name == "dropout_local":
        return pts, C.dropout_local(pts, ones, draws.op)
    if name == "add_global":
        return C.add_global(pts, ones, lv, draws.op)
    if name == "add_local":
        return C.add_local(pts, ones, lv, draws.op)
    raise NotImplementedError(name)


def _corrupt_level(pts: torch.Tensor, name: str, level: int, draws: LevelDraws
                   ) -> torch.Tensor:
    """The cell's corruption at a fixed severity, the output n points a
    cloud: scale U(1/s, s)^3 then ``pc_normalize`` (s 1.6 .. 2.0), jitter
    sigma 0.01 (level + 1), Euler rotation within pi (level + 1) / 5,
    global dropout at rate 0.25 .. 0.75, local dropout of 0.1 (level + 1)
    of the points, adds of int(n (level + 1) 0.1) points into a buffer of n
    + n // 2; the masked families resampled back to n."""
    out, mask = level_cloud(pts, name, level, draws)
    if mask is None:
        return out
    return resample_batch(out, mask, pts.shape[1], draws=draws.resample)


def corrupt_batch_level(pts: torch.Tensor, name: str, level: int,
                        draws: Optional[LevelDraws] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``_corrupt_level`` over (B, n, 3) clouds, drawn from ``generator``
    when ``draws`` is None."""
    if draws is None:
        draws = sample_level_draws(name, level, pts.shape[0], pts.shape[1], generator,
                                   pts.device)
    return _corrupt_level(pts, name, level, draws)


def load_modelnet_c_split(data_root: str, split: str):
    """One ModelNet-C h5 file, ``{data_root}/{split}.h5``: (data (N, P, 3)
    f32, P varying by cell; labels (N,) int64)."""
    from ..data.datasets import _h5py

    h5py = _h5py("ModelNet-C")
    with h5py.File(os.path.join(data_root, f"{split}.h5"), "r") as f:
        data = np.asarray(f["data"][:], np.float32)
        label = np.asarray(f["label"][:]).reshape(-1).astype(np.int64)
    return data, label


def has_modelnet_c(data_root: Optional[str]) -> bool:
    return bool(data_root) and os.path.isfile(os.path.join(data_root, "clean.h5"))


def missing_modelnet_c_files(data_root: str, corruptions: Sequence[str] = CORRUPTIONS,
                             levels: int = 5) -> list:
    """The requested cells whose h5 file is absent, checked before the first
    cell so that an incomplete root fails at once."""
    splits = ["clean"] + [f"{c}_{lv}" for c in corruptions for lv in range(levels)]
    return [s for s in splits if not os.path.isfile(os.path.join(data_root, f"{s}.h5"))]


def _batched_accuracy(eval_fn: Callable, pts, labels: np.ndarray, batch_size: int) -> float:
    """The accuracy (a fraction) of ``eval_fn`` over ``pts`` (numpy, or a
    tensor on the device), in chunks of ``batch_size``, the tail chunk
    zero-padded and its padding's logits dropped."""
    correct = 0
    for s in range(0, len(pts), batch_size):
        chunk = pts[s:s + batch_size]
        n = chunk.shape[0]
        if n < batch_size:
            if isinstance(chunk, torch.Tensor):
                chunk = torch.cat([chunk, chunk.new_zeros((batch_size - n,) + chunk.shape[1:])])
            else:
                chunk = np.pad(chunk, ((0, batch_size - n),) + ((0, 0),) * (chunk.ndim - 1))
        logits = eval_fn(chunk)
        logits = logits.detach().cpu().numpy() if isinstance(logits, torch.Tensor) \
            else np.asarray(logits)
        correct += int((np.argmax(logits[:n], -1) == labels[s:s + n]).sum())
    return correct / max(len(pts), 1)


def eval_corrupt_wrapper(eval_fn: Callable, dataset, batch_size: int,
                         corruptions: Sequence[str] = CORRUPTIONS, levels: int = 5,
                         seed: int = 0, data_root: Optional[str] = None,
                         logger=None, device=None) -> Dict[str, float]:
    """Evaluate ``eval_fn(points (B, N, 3)) -> logits`` on the clean set and
    every corruption x severity. With the ModelNet-C files in ``data_root``
    the cells are those files (``dataset`` may be None); otherwise the test
    set is read once into a tensor on ``device`` and each cell corrupts it
    whole there. Returns each cell's OA, the clean OA and mOA / mCE / RmCE;
    the log lines are ``modelnetc_utils``' dicts."""
    use_files = has_modelnet_c(data_root)
    if use_files:
        missing = missing_modelnet_c_files(data_root, corruptions, levels)
        if missing:
            raise FileNotFoundError(
                f"ModelNet-C root {data_root} is incomplete - missing "
                f"{len(missing)} file(s): " + ", ".join(f"{s}.h5" for s in missing))
        print_log(f"[Corruption] evaluating pre-generated ModelNet-C files "
                  f"at {data_root}", logger=logger)
    else:
        print_log("[Corruption] no ModelNet-C files found - generating "
                  "corruptions on device (NOT comparable to the published "
                  "benchmark numbers)", logger=logger)
        from ..data.loader import DataLoader

        dev = resolve_device(device)
        all_pts, all_labels = [], []
        for batch in DataLoader(dataset, batch_size, shuffle=False, drop_last=False):
            all_pts.append(np.asarray(batch["points"][..., :3], np.float32))
            all_labels.append(np.asarray(batch["label"]).reshape(-1))
        ds_pts = torch.from_numpy(np.concatenate(all_pts) if all_pts else
                                  np.zeros((0, 1, 3), np.float32)).to(dev)
        ds_labels = np.concatenate(all_labels) if all_labels else np.zeros((0,), np.int64)

    def accuracy(corrupt: Optional[tuple]) -> float:
        if use_files:
            split = "clean" if corrupt is None else f"{corrupt[0]}_{corrupt[1]}"
            pts, labels = load_modelnet_c_split(data_root, split)
            return _batched_accuracy(eval_fn, pts[..., :3], labels, batch_size)
        pts_cell = ds_pts
        if corrupt is not None and len(ds_pts):
            g = torch.Generator(device=ds_pts.device).manual_seed(seed)
            pts_cell = corrupt_batch_level(ds_pts, corrupt[0], corrupt[1], generator=g)
        return _batched_accuracy(eval_fn, pts_cell, ds_labels, batch_size)

    oa_clean = accuracy(None)
    print_log(f"{{'OA': {round(oa_clean, 3)}, 'corruption': 'clean', "
              f"'level': 'Overall'}}", logger=logger)
    per_level: Dict[str, list] = {}
    for name in corruptions:
        per_level[name] = []
        for lv in range(levels):
            oa = accuracy((name, lv))
            per_level[name].append(oa)
            print_log(f"{{'acc': {oa}, 'corruption': '{name}', 'level': {lv}}}",
                      logger=logger)
    results = corruption_metrics(per_level, oa_clean)
    for name in corruptions:
        print_log(f"{{'CE': {round(results[f'{name}_CE'], 3)}, "
                  f"'OA': {round(results[f'{name}_OA'], 3)}, "
                  f"'RCE': {round(results[f'{name}_RCE'], 3)}, "
                  f"'corruption': '{name}', 'level': 'Overall'}}", logger=logger)
    print_log(f"{{'RmCE': {round(results['RmCE'], 3)}, "
              f"'mCE': {round(results['mCE'], 3)}, "
              f"'mOA': {round(results['mOA'], 3)}}}", logger=logger)
    return results


def corruption_metrics(per_level_oa: Dict[str, Sequence[float]],
                       clean_oa: float) -> Dict[str, float]:
    """ModelNet-C aggregation: CE_c = ER_c / refER_c and RCE_c = (ER_c -
    ER_clean) / (refER_c - refER_clean), ER the error of the mean OA over
    the levels; mCE, RmCE and mOA their means over the corruptions. Every
    OA is rounded to 3 decimals before the ratios, as ``modelnetc_utils``
    does (without it the reference log's scale CE is 0.959, not 0.957)."""
    results: Dict[str, float] = {"clean_OA": clean_oa}
    clean_er = 1.0 - round(clean_oa, 3)
    ce_list, rce_list, oa_list = [], [], []
    for name, oas in per_level_oa.items():
        for lv, oa in enumerate(oas):
            results[f"{name}_{lv}_OA"] = float(oa)
        mean_oa = round(float(np.mean(oas)), 3)
        er = 1.0 - mean_oa
        ref = DGCNN_REF_ER.get(name, 0.2)
        ce = er / ref
        rce = (er - clean_er) / max(ref - DGCNN_REF_ER["clean"], 1e-6)
        oa_list.append(mean_oa)
        ce_list.append(ce)
        rce_list.append(rce)
        results[f"{name}_OA"] = mean_oa
        results[f"{name}_CE"] = ce
        results[f"{name}_RCE"] = rce
    results["mOA"] = float(np.mean(oa_list))
    results["mCE"] = float(np.mean(ce_list))
    results["RmCE"] = float(np.mean(rce_list))
    return results


def test_net_corruption(config, args, logger_name: str = "PointDAE",
                        device=None) -> Dict[str, float]:
    """``--test_corruption`` (runner_finetune.py:660-683): the ``--ckpts``
    classifier on ModelNet-C. The data root is ``--modelnet_c_root``, the
    config's ``modelnet_c_root`` or ``data/modelnet_c``; on its files the
    raw eval step (no resample), else the generated cells through the FPS
    eval step."""
    from ..data.datasets import build_dataset_from_cfg
    from ..models import build_model_from_cfg
    from .finetune import _warm_start, make_eval_step, make_eval_step_raw

    dev = resolve_device(device)
    dcfg = config["dataset"]
    test_set = build_dataset_from_cfg(dcfg["test"]["_base_"], dcfg["test"]["others"],
                                      device=dev)
    total_bs = int(config.get("total_bs", 32))
    model = build_model_from_cfg(config["model"], device=dev, seed=0)
    if getattr(args, "ckpts", None):
        _warm_start(model, args.ckpts, logger_name)
    data_root = (getattr(args, "modelnet_c_root", None) or config.get("modelnet_c_root")
                 or "data/modelnet_c")
    if has_modelnet_c(data_root):
        step = make_eval_step_raw(model, device=dev)
    else:
        step = make_eval_step(model, config, device=dev)

    def eval_fn(pts):
        # under a process group each rank runs its rows of the batch
        return sharded_eval(step, torch.as_tensor(pts))

    return eval_corrupt_wrapper(eval_fn, test_set, total_bs, data_root=data_root,
                                logger=logger_name, device=dev)
