"""Dataset readers (the port's copy of ``point_dae_tpu/data/datasets.py``;
reference: datasets/*.py).

Datasets only read raw clouds from disk (npy/h5/txt/pkl/dat) and return
numpy arrays and labels; augmentation, corruption and resampling run on the
device inside the train step (``engine/pretrain.py:device_pipeline``).

Each dataset registers in ``DATASETS`` and is built from the same YAML
config shape as the reference (``_base_`` dataset file + ``others``
overrides, datasets/build.py:7-15). ``Synthetic`` provides deterministic
clouds for tests and benchmarks when no real data is mounted. The h5
readers import ``h5py`` when they are constructed, and raise an
``ImportError`` naming the reader on a host without it.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from ..utils.logger import print_log
from ..utils.registry import DATASETS


def _h5py(reader: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"the {reader} reader needs the h5py package, which "
                          f"this host does not have") from e
    return h5py


def _cfg_get(cfg, key, default=None):
    if hasattr(cfg, key):
        return getattr(cfg, key)
    if isinstance(cfg, dict):
        return cfg.get(key, default)
    return default


class PointDataset:
    """Minimal dataset protocol: __len__ + __getitem__ -> dict with
    'points' (N, C) float32 and optional 'label' int / 'seg' (N,) / ids."""

    def __len__(self):  # pragma: no cover - interface
        raise NotImplementedError

    def __getitem__(self, idx):  # pragma: no cover - interface
        raise NotImplementedError


@DATASETS.register_module()
class ShapeNet(PointDataset):
    """ShapeNet-55 pretraining set (datasets/ShapeNet55Dataset.py:26-122):
    npy clouds of N_POINTS (8192) x 3 or 6 (with normals); ``whole=True``
    concatenates train+test lists. Returns the raw cloud; the device pipeline
    reproduces augment -> corrupt -> independent resample of corrupted/clean.
    """

    def __init__(self, config):
        self.data_root = _cfg_get(config, "DATA_PATH")
        self.pc_path = _cfg_get(config, "PC_PATH")
        self.subset = _cfg_get(config, "subset", "train")
        self.npoints = int(_cfg_get(config, "npoints", 1024))
        self.n_points_raw = int(_cfg_get(config, "N_POINTS", 8192))
        self.with_normal = bool(_cfg_get(config, "with_normal", True))
        self.whole = bool(_cfg_get(config, "whole", False))
        lines: List[str] = []
        list_file = os.path.join(self.data_root, f"{self.subset}.txt")
        with open(list_file) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        if self.whole:
            other = "test" if self.subset == "train" else "train"
            with open(os.path.join(self.data_root, f"{other}.txt")) as f:
                lines += [ln.strip() for ln in f if ln.strip()]
        self.file_list = []
        for line in lines:
            taxonomy_id = line.split("-")[0]
            model_id = line.split("-")[1].split(".")[0]
            self.file_list.append(dict(taxonomy_id=taxonomy_id,
                                       model_id=model_id, file_path=line))
        print_log(f"[ShapeNet] {len(self.file_list)} instances "
                  f"({self.subset}{'+whole' if self.whole else ''})",
                  logger="ShapeNet-55")

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, idx):
        s = self.file_list[idx]
        data = np.load(os.path.join(self.pc_path, s["file_path"])).astype(np.float32)
        return dict(points=data, taxonomy_id=s["taxonomy_id"],
                    model_id=s["model_id"])

    def load_batch(self, indices):
        """Whole-batch load through the native threaded .npy reader
        (native/pointio.cpp; role of the reference's multi-worker torch
        DataLoader). Falls back to per-item loads when any file fails; a
        reader that cannot be built raises."""
        from . import native_io

        samples = [self.file_list[i] for i in indices]
        n_cols = 6 if self.with_normal else 3
        paths = [os.path.join(self.pc_path, s["file_path"]) for s in samples]
        pts, ok = native_io.load_npy_batch(paths, self.n_points_raw, n_cols)
        if bool(ok.all()):
            return dict(
                points=pts,
                taxonomy_id=np.asarray([s["taxonomy_id"] for s in samples]),
                model_id=np.asarray([s["model_id"] for s in samples]))
        out = [self[int(i)] for i in indices]
        return {k: np.stack([o[k] for o in out]) if k == "points"
                else np.asarray([o[k] for o in out]) for k in out[0]}


@DATASETS.register_module()
class ModelNet(PointDataset):
    """ModelNet40 with the offline-FPS cache layout
    (datasets/ModelNetDataset.py:57-158): ``modelnet40_{split}_8192pts_fps.dat``
    pickle of (points list, labels list)."""

    def __init__(self, config, device=None):
        self.root = _cfg_get(config, "DATA_PATH")
        self.npoints = int(_cfg_get(config, "N_POINTS", 8192))
        self.device = device
        self.use_normals = bool(_cfg_get(config, "USE_NORMALS", False))
        self.subset = _cfg_get(config, "subset", "train")
        cache = os.path.join(self.root,
                             f"modelnet40_{self.subset}_{self.npoints}pts_fps.dat")
        if not os.path.exists(cache):
            self._build_cache(cache)
        with open(cache, "rb") as f:
            self.points, self.labels = pickle.load(f)
        print_log(f"[ModelNet] {len(self.points)} clouds ({self.subset})",
                  logger="ModelNet")

    def _build_cache(self, cache: str) -> None:
        """Build the offline-FPS cache from the txt layout
        (modelnet40_normal_resampled, ModelNetDataset.py:92-122): per-sample
        txt of x,y,z,nx,ny,nz rows, FPS'd to N_POINTS on the device (the
        card unless the reader was given ``device='cpu'``)."""
        import torch

        from ..ops.geometry import furthest_point_sample, gather_points
        from ..utils.device import resolve_device

        dev = resolve_device(self.device)

        names_file = os.path.join(self.root, "modelnet40_shape_names.txt")
        split_file = os.path.join(self.root,
                                  f"modelnet40_{self.subset}.txt")
        with open(names_file) as f:
            classes = {c.strip(): i for i, c in enumerate(f) if c.strip()}
        with open(split_file) as f:
            ids = [ln.strip() for ln in f if ln.strip()]
        points, labels = [], []
        for sid in ids:
            cname = "_".join(sid.split("_")[:-1])
            path = os.path.join(self.root, cname, f"{sid}.txt")
            data = np.loadtxt(path, delimiter=",").astype(np.float32)
            if data.shape[0] > self.npoints:
                p = torch.from_numpy(data[None]).to(dev)
                data = gather_points(p, furthest_point_sample(
                    p[..., :3].contiguous(), self.npoints))[0].cpu().numpy()
            points.append(data)
            labels.append(np.asarray([classes[cname]], np.int32))
        with open(cache, "wb") as f:
            pickle.dump((points, labels), f)
        print_log(f"[ModelNet] built FPS cache {cache}", logger="ModelNet")

    def __len__(self):
        return len(self.points)

    def __getitem__(self, idx):
        pts = np.asarray(self.points[idx], np.float32)
        if not self.use_normals:
            pts = pts[:, :3]
        label = int(np.asarray(self.labels[idx]).reshape(-1)[0])
        return dict(points=pts, label=label)


@DATASETS.register_module()
class ModelNet_Official(ModelNet):
    """Alias with the official 2048-pt h5 layout if present, else the cache."""


@DATASETS.register_module()
class ScanObjectNN(PointDataset):
    """ScanObjectNN OBJ_BG (datasets/ScanObjectNNDataset.py:57-94):
    h5 'data' (B, 2048, 3) + 'label'."""

    h5_name = {"train": "training_objectdataset.h5",
               "test": "test_objectdataset.h5"}

    def __init__(self, config):
        h5py = _h5py(type(self).__name__)
        self.root = _cfg_get(config, "ROOT", _cfg_get(config, "DATA_PATH"))
        self.subset = _cfg_get(config, "subset", "train")
        with h5py.File(os.path.join(self.root, self.h5_name[self.subset]), "r") as f:
            self.points = np.asarray(f["data"], np.float32)
            self.labels = np.asarray(f["label"], np.int64)
        print_log(f"[ScanObjectNN] {len(self.points)} clouds ({self.subset})",
                  logger="ScanObjectNN")

    def __len__(self):
        return len(self.points)

    def __getitem__(self, idx):
        return dict(points=self.points[idx], label=int(self.labels[idx]))


@DATASETS.register_module()
class ScanObjectNN_hardest(ScanObjectNN):
    """PB_T50_RS split (datasets/ScanObjectNNDataset.py:98-167)."""

    h5_name = {"train": "training_objectdataset_augmentedrot_scale75.h5",
               "test": "test_objectdataset_augmentedrot_scale75.h5"}


@DATASETS.register_module()
class ModelNetFewShot(PointDataset):
    """Few-shot folds (datasets/ModelNetDatasetFewShot.py:28-71):
    ``{way}way_{shot}shot/{fold}.pkl`` -> dict with 'train'/'test' lists of
    (points, label)."""

    def __init__(self, config):
        root = _cfg_get(config, "DATA_PATH")
        way = int(_cfg_get(config, "way", 5))
        shot = int(_cfg_get(config, "shot", 10))
        fold = int(_cfg_get(config, "fold", 0))
        self.subset = _cfg_get(config, "subset", "train")
        path = os.path.join(root, f"{way}way_{shot}shot", f"{fold}.pkl")
        with open(path, "rb") as f:
            data = pickle.load(f)[self.subset]
        self.points = [np.asarray(p, np.float32) for p, _ in data]
        self.labels = [int(l) for _, l in data]

    def __len__(self):
        return len(self.points)

    def __getitem__(self, idx):
        return dict(points=self.points[idx], label=self.labels[idx])


@DATASETS.register_module()
class ShapeNetPart(PointDataset):
    """ShapeNetPart segmentation set (segmentation/dataset.py:65-167):
    per-category txt files of x y z nx ny nz seg_label."""

    seg_classes = {
        "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35],
        "Rocket": [41, 42, 43], "Car": [8, 9, 10, 11], "Laptop": [28, 29],
        "Cap": [6, 7], "Skateboard": [44, 45, 46], "Mug": [36, 37],
        "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
        "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3],
        "Pistol": [38, 39, 40], "Chair": [12, 13, 14, 15],
        "Knife": [22, 23]}

    def __init__(self, config):
        import json

        self.root = _cfg_get(config, "DATA_PATH")
        self.npoints = int(_cfg_get(config, "npoints", 2048))
        self.subset = _cfg_get(config, "subset", "train")
        self.use_normals = bool(_cfg_get(config, "normal_channel", False))
        cat_file = os.path.join(self.root, "synsetoffset2category.txt")
        self.cat = {}
        with open(cat_file) as f:
            for ln in f:
                name, synset = ln.strip().split()
                self.cat[name] = synset
        # distinct splits like the reference (segmentation/dataset.py:98-106:
        # 'train' is train-only; training recipes use 'trainval')
        splits = {"train": ["train"], "val": ["val"],
                  "trainval": ["train", "val"], "test": ["test"]}[self.subset]
        ids = set()
        for sp in splits:
            with open(os.path.join(
                    self.root, "train_test_split",
                    f"shuffled_{sp}_file_list.json")) as f:
                ids |= {os.path.basename(x) for x in json.load(f)}
        self.files: List[Tuple[str, str]] = []
        for name, synset in self.cat.items():
            if name not in self.seg_classes:    # unknown category name
                continue
            d = os.path.join(self.root, synset)
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if fn.split(".")[0] in ids:
                    self.files.append((name, os.path.join(d, fn)))
        # canonical 16-category indices (sorted seg_classes names), NOT an
        # enumeration of whatever categories the cat file happens to list:
        # run_partseg maps labels back through sorted(SEG_CLASSES), so a
        # partial category file must not shift later indices
        canon = sorted(self.seg_classes)
        self.classes = {name: canon.index(name) for name in self.cat
                        if name in self.seg_classes}

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        name, path = self.files[idx]
        data = np.loadtxt(path).astype(np.float32)
        pts = data[:, :6] if self.use_normals else data[:, :3]
        seg = data[:, -1].astype(np.int32)
        # pad/subsample to npoints
        n = pts.shape[0]
        if n >= self.npoints:
            choice = np.random.choice(n, self.npoints, replace=False)
        else:
            choice = np.concatenate(
                [np.arange(n), np.random.choice(n, self.npoints - n, replace=True)])
        return dict(points=pts[choice], seg=seg[choice],
                    label=self.classes[name])


@DATASETS.register_module()
class ShapeNetClass(ShapeNet):
    """ShapeNet-55 with taxonomy labels for supervised/task-affinity variants
    (datasets/ShapeNet55DatasetClass.py:45-167): taxonomy id -> class index
    from the sorted unique taxonomy list."""

    def __init__(self, config):
        super().__init__(config)
        taxonomies = sorted({s["taxonomy_id"] for s in self.file_list})
        self.tax2label = {t: i for i, t in enumerate(taxonomies)}

    def __getitem__(self, idx):
        item = super().__getitem__(idx)
        item["label"] = self.tax2label[item["taxonomy_id"]]
        return item


@DATASETS.register_module()
class Objaverse_8192(PointDataset):
    """Directory-walk .npy loader for large-scale pretraining
    (datasets/Objaverse_8192.py:26-128)."""

    def __init__(self, config):
        root = _cfg_get(config, "DATA_PATH")
        self.files: List[str] = []
        for dirpath, _, files in os.walk(root):
            for fn in files:
                if fn.endswith(".npy"):
                    self.files.append(os.path.join(dirpath, fn))
        self.files.sort()
        print_log(f"[Objaverse] {len(self.files)} clouds", logger="Objaverse")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        data = np.load(self.files[idx]).astype(np.float32)
        return dict(points=data, taxonomy_id="objaverse",
                    model_id=os.path.basename(self.files[idx]))


@DATASETS.register_module()
class ScanNet(PointDataset):
    """Scene-level json catalog of .npy files (datasets/ScanNet.py:11-51):
    pretraining returns the scene cloud as both corrupted source and target.
    """

    def __init__(self, config):
        import json

        root = _cfg_get(config, "DATA_PATH")
        catalog = _cfg_get(config, "CATALOG",
                           os.path.join(root, "scannet_medium.json"))
        with open(catalog) as f:
            self.files = json.load(f)
        self.root = root
        self.npoints = int(_cfg_get(config, "N_POINTS", 8192))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        data = np.load(os.path.join(self.root, self.files[idx])).astype(np.float32)
        if data.shape[0] > self.npoints:
            sel = np.random.choice(data.shape[0], self.npoints, replace=False)
            data = data[sel]
        return dict(points=data, taxonomy_id="scannet", model_id=str(idx))


# PointDA-10 shared label map (domain_generalization.py:41-45)
DG_LABEL_TO_IDX = {"bathtub": 0, "bed": 1, "bookshelf": 2, "cabinet": 3,
                   "chair": 4, "lamp": 5, "monitor": 6, "plant": 7,
                   "sofa": 8, "table": 9}


def dg_normal_pc(pc: np.ndarray) -> np.ndarray:
    """Center + max-L2-norm normalize (normal_pc,
    domain_generalization.py:29-38)."""
    pc = pc - pc.mean(axis=0)
    return (pc / np.max(np.sqrt(np.sum(pc ** 2, axis=-1)))).astype(np.float32)


def dg_rotate_shape_x(pc: np.ndarray, angle: float) -> np.ndarray:
    """rotate_shape(x, 'x', angle) (domain_generalization.py:118-136)."""
    c, s = np.cos(angle), np.sin(angle)
    r = np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]], pc.dtype)
    return pc.dot(r).astype(np.float32)


class _DGNpyDirBase(PointDataset):
    """Per-class .npy directory layout shared by the ModelNet/ShapeNet DG
    domains ({root}/{class}/{split}/*.npy, labels = the canonical
    PointDA-10 map applied to the class-directory names,
    domain_generalization.py:300-314). Host-side work mirrors the
    reference __getitem__ normalization/orientation; the random FPS
    resample + shuffle + z-rotation + jitter train augs run ON DEVICE in
    the finetune step ('dg' train_aug + FPS resample) — the models are
    permutation-invariant, so the host shuffle is a no-op by design."""

    def __init__(self, config):
        root = _cfg_get(config, "DATA_PATH")
        self.subset = _cfg_get(config, "subset", "train")
        self.npoints = int(_cfg_get(config, "N_POINTS", 1024))
        # labels come from the canonical PointDA-10 map, NOT the directory
        # enumeration order: a partial dump (missing/extra class dirs) must
        # not shift indices relative to Scannet_DG's h5-stored labels
        categorys = sorted(d for d in os.listdir(root)
                           if os.path.isdir(os.path.join(root, d))
                           and d in DG_LABEL_TO_IDX)
        self.classes = sorted(DG_LABEL_TO_IDX, key=DG_LABEL_TO_IDX.get)
        self.items: List[Tuple[str, int]] = []
        for cname in categorys:
            li = DG_LABEL_TO_IDX[cname]
            d = os.path.join(root, cname, self.subset)
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if fn.endswith(".npy"):
                    self.items.append((os.path.join(d, fn), li))
        print_log(f"[{type(self).__name__}] {len(self.items)} clouds "
                  f"({self.subset})", logger="DG")

    def __len__(self):
        return len(self.items)


@DATASETS.register_module()
class Modelnet40_DG(_DGNpyDirBase):
    """ModelNet DG domain (domain_generalization.py:282-341): full cloud
    loaded, xyz only, normalized; no orientation fix."""

    def __getitem__(self, idx):
        path, label = self.items[idx]
        pc = np.load(path)[:, :3].astype(np.float32)
        return dict(points=dg_normal_pc(pc), label=label)


@DATASETS.register_module()
class Shapenet_DG(_DGNpyDirBase):
    """ShapeNet DG domain (domain_generalization.py:343-434): truncate to
    npoints BEFORE normalizing, then the label-conditional orientation fix
    rotate_pc (:425-429): -pi/2 about x for every class except 'plant'
    (ShapeNet shapes are y-up except plants)."""

    def __getitem__(self, idx):
        path, label = self.items[idx]
        pc = np.load(path)[:self.npoints].astype(np.float32)[:, :3]
        pc = dg_normal_pc(pc)
        if self.classes[label] != "plant":
            pc = dg_rotate_shape_x(pc, -np.pi / 2)
        return dict(points=pc, label=label)


@DATASETS.register_module()
class Scannet_DG(PointDataset):
    """ScanNet DG domain (domain_generalization.py:436-507): h5 shards
    listed in {root}/{train,test}_files.txt (each h5: 'data' + 'label'),
    truncate to npoints, normalize, then the unconditional -pi/2 x-rotation
    (:501-504, ScanNet is y-up)."""

    def __init__(self, config):
        h5py = _h5py("Scannet_DG")
        root = _cfg_get(config, "DATA_PATH")
        self.subset = _cfg_get(config, "subset", "train")
        self.npoints = int(_cfg_get(config, "N_POINTS", 1024))
        name = "train_files.txt" if self.subset == "train" else "test_files.txt"
        with open(os.path.join(root, name)) as f:
            # load_dir keeps only the basename and re-roots it (:222-225)
            paths = [os.path.join(root, ln.rstrip().split("/")[-1])
                     for ln in f if ln.strip()]
        pts, lbls = [], []
        for pth in paths:
            with h5py.File(pth, "r") as df:
                pts.append(np.asarray(df["data"][:]))
                lbls.append(np.asarray(df["label"][:]).reshape(-1))
        self.data = np.concatenate(pts, axis=0)
        self.label = np.concatenate(lbls, axis=0).astype(np.int64)
        print_log(f"[Scannet_DG] {len(self.data)} clouds ({self.subset})",
                  logger="DG")

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, idx):
        pc = self.data[idx][:self.npoints].astype(np.float32)[:, :3]
        pc = dg_normal_pc(pc)
        pc = dg_rotate_shape_x(pc, -np.pi / 2)
        return dict(points=pc, label=int(self.label[idx]))


@DATASETS.register_module()
class Synthetic(PointDataset):
    """Deterministic procedural clouds for tests and benchmarking without
    mounted data: unions of random ellipsoid surface patches, unit-sphere
    normalised, with surface normals. Labelled by generation seed bucket so
    classification paths are exercisable."""

    def __init__(self, config):
        self.n = int(_cfg_get(config, "size", 512))
        self.npoints = int(_cfg_get(config, "N_POINTS", 2048))
        self.num_classes = int(_cfg_get(config, "num_classes", 15))
        self.with_normals = bool(_cfg_get(config, "with_normal", True))
        self.seed = int(_cfg_get(config, "seed", 0))

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        label = idx % self.num_classes
        # class identity = blob count (1..8) x elongation regime, arranged on
        # a fixed ring so the structure is stable across instances/seeds —
        # strong enough signal for learning-sanity checks
        k = 1 + label % 8
        elong = 1.0 + 2.0 * (label // 8)
        ang = np.arange(k) * 2 * np.pi / max(k, 1)
        ring = 0.0 if k == 1 else 0.6
        centers = np.stack([ring * np.cos(ang), ring * np.sin(ang),
                            np.zeros(k)], axis=1)
        centers += rng.normal(0, 0.05, centers.shape)
        radii = np.tile(np.array([[0.25, 0.25, 0.25 * elong]]), (k, 1))
        radii *= 1.0 + 0.1 * rng.standard_normal((k, 3))
        counts = np.full(k, self.npoints // k)
        counts[0] += self.npoints - counts.sum()
        pts, nrm = [], []
        for c, r, m in zip(centers, radii, counts):
            u = rng.normal(size=(m, 3))
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            pts.append(c + u * r)
            nn = u / r
            nrm.append(nn / np.linalg.norm(nn, axis=1, keepdims=True))
        pts = np.concatenate(pts).astype(np.float32)
        nrm = np.concatenate(nrm).astype(np.float32)
        centroid = pts.mean(0)
        pts -= centroid
        pts /= np.abs(np.linalg.norm(pts, axis=1)).max()
        out = np.concatenate([pts, nrm], 1) if self.with_normals else pts
        return dict(points=out, label=label,
                    taxonomy_id=f"syn{label:02d}", model_id=f"{idx:06d}")


def build_dataset_from_cfg(base_cfg, others=None, device=None):
    """datasets/build.py:7-15 equivalent: merge ``others`` into the base
    dataset config and build by NAME. ``device`` reaches the ModelNet
    readers, which build their FPS cache on it (default: the card)."""
    merged = dict(base_cfg)
    if others:
        merged.update(dict(others))
    cls = DATASETS.get(merged["NAME"])
    if issubclass(cls, ModelNet):
        return cls(merged, device=device)
    return cls(merged)
