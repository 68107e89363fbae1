"""The port's data layer against the JAX package on the CPU: every registered
reader returns the same arrays from the same files (``Synthetic`` bit for
bit, ``ShapeNet`` through the native reader and per item, the h5 readers,
``ShapeNetPart`` under one ``np.random.seed``); the loader's batches are the
JAX loader's; the native reader matches ``np.load`` and builds outside
``native/``; the device cache serves each row once an epoch; the
augmentations keep their contracts."""
import json
import os
import pathlib
import pickle

import numpy as np
import pytest
import torch

from point_dae_tpu.data import datasets as jds
from point_dae_tpu.data.loader import DataLoader as JDataLoader

from point_dae_torch.data import datasets as tds
from point_dae_torch.data import native_io, transforms
from point_dae_torch.data.device_cache import DTYPES, build_device_cache
from point_dae_torch.data.loader import DataLoader
from point_dae_torch.utils.registry import DATASETS

from _torch_files import one_torch_thread, partseg_tree  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SYN = {"NAME": "Synthetic", "size": 12, "N_POINTS": 64, "num_classes": 5,
       "with_normal": True, "seed": 3}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _both(cfg, others=None):
    return (tds.build_dataset_from_cfg(cfg, others, device="cpu"),
            jds.build_dataset_from_cfg(cfg, others))


def _npy_tree(root, n=6, rows=32, cols=6):
    """A ShapeNet-55 layout: train.txt / test.txt lists of <tax>-<id>.npy."""
    rng = np.random.default_rng(0)
    pc = root / "pc"
    pc.mkdir()
    names = [f"{'0234' if i % 2 else '0369'}-m{i:03d}.npy" for i in range(n)]
    for i, name in enumerate(names):
        np.save(pc / name, rng.normal(size=(rows, cols)).astype(np.float32 if i % 3 else np.float64))
    (root / "train.txt").write_text("\n".join(names[:4]) + "\n")
    (root / "test.txt").write_text("\n".join(names[4:]) + "\n")
    return {"DATA_PATH": str(root), "PC_PATH": str(pc), "N_POINTS": rows,
            "with_normal": cols == 6}


def test_synthetic_bit_equal():
    t, j = _both(SYN, {"with_normal": False})
    assert len(t) == len(j) == 12
    for i in (0, 5, 11):
        _same(t[i], j[i])
    t, j = _both(SYN)
    _same(t[7], j[7])


@pytest.mark.parametrize("whole", [False, True])
def test_shapenet_native_and_per_item(tmp_path, whole):
    cfg = dict(_npy_tree(tmp_path), NAME="ShapeNet", subset="train", whole=whole)
    t, j = _both(cfg)
    assert len(t) == len(j) == (6 if whole else 4)
    for i in range(len(t)):
        _same(t[i], j[i])
    idx = [3, 0, 2]
    want = {k: np.stack([j[i][k] for i in idx]) if k == "points"
            else np.asarray([j[i][k] for i in idx]) for k in j[0]}
    _same(t.load_batch(idx), want)                  # native reader
    f = os.path.join(cfg["PC_PATH"], t.file_list[3]["file_path"])
    np.save(f, np.load(f).astype(np.float16))       # the native reader refuses f16
    got = t.load_batch(idx)
    assert got["points"].shape == (3, 32, 6)
    _same(got, {k: np.stack([j[i][k] for i in idx]) if k == "points"
                else np.asarray([j[i][k] for i in idx]) for k in j[0]})


def test_native_io_matches_np_load_and_builds_outside_native(tmp_path):
    native = ROOT / "native"
    before = {p.name: p.stat().st_mtime_ns for p in native.iterdir()}
    rng = np.random.default_rng(1)
    paths = []
    for i, dt in enumerate((np.float32, np.float64, np.float32)):
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], rng.normal(size=(50, 6)).astype(dt))
    out, ok = native_io.load_npy_batch(paths + [str(tmp_path / "missing.npy")], 50, 6)
    assert ok.tolist() == [True, True, True, False]
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(out[i], np.load(p).astype(np.float32))
    out3, _ = native_io.load_npy_batch(paths[:1], 50, 3)
    np.testing.assert_array_equal(out3[0], np.load(paths[0])[:, :3])
    sub, ok = native_io.load_npy_batch(paths[:1], 20, 6)        # subsample without replacement
    assert ok.all() and len({tuple(r) for r in sub[0]}) == 20
    img = native_io.render_balls(np.load(paths[0])[:, :3] * 0.3, h=32, w=32)
    assert img.shape == (32, 32, 3) and img.max() > 0
    assert os.path.dirname(native_io.lib_path()) == str(ROOT / "build" / "torch_native")
    assert {p.name: p.stat().st_mtime_ns for p in native.iterdir()} == before


def _h5(path, n, pts, seed):
    import h5py

    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f["data"] = rng.normal(size=(n, pts, 3)).astype(np.float32)
        f["label"] = rng.integers(0, 10, (n, 1)).astype(np.int64)


@pytest.mark.parametrize("name", ["ScanObjectNN", "ScanObjectNN_hardest"])
def test_scanobjectnn_h5(tmp_path, name):
    cls = DATASETS.get(name)
    _h5(tmp_path / cls.h5_name["test"], 5, 40, 2)
    t, j = _both({"NAME": name, "ROOT": str(tmp_path), "subset": "test"})
    assert len(t) == len(j) == 5
    for i in range(5):
        _same(t[i], j[i])


def test_scannet_dg_h5(tmp_path):
    for k in range(2):
        _h5(tmp_path / f"shard{k}.h5", 3, 50, k)
    (tmp_path / "test_files.txt").write_text("data/shard0.h5\ndata/shard1.h5\n")
    t, j = _both({"NAME": "Scannet_DG", "DATA_PATH": str(tmp_path), "subset": "test",
                  "N_POINTS": 32})
    assert len(t) == len(j) == 6
    for i in range(6):
        _same(t[i], j[i])


def test_h5_readers_name_themselves_without_h5py(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    for name in ("ScanObjectNN", "ScanObjectNN_hardest", "Scannet_DG"):
        with pytest.raises(ImportError, match=name):
            tds.build_dataset_from_cfg({"NAME": name, "ROOT": str(tmp_path),
                                        "DATA_PATH": str(tmp_path), "subset": "test"})


@pytest.mark.parametrize("subset,npoints,normals", [("trainval", 32, False),
                                                     ("test", 64, True)])
def test_shapenetpart_under_one_seed(tmp_path, subset, npoints, normals):
    cfg = dict(partseg_tree(tmp_path), subset=subset, npoints=npoints,
               normal_channel=normals)
    t, j = _both(cfg)
    assert len(t) == len(j) > 0 and t.classes == j.classes
    for i in range(len(t)):
        np.random.seed(11 + i)
        a = t[i]
        np.random.seed(11 + i)
        _same(a, j[i])


def _reader_files(name, root):
    """Files for one of the remaining readers, and its config."""
    rng = np.random.default_rng(9)
    if name in ("ModelNet", "ModelNet_Official"):
        pts = [rng.normal(size=(16, 6)).astype(np.float32) for _ in range(4)]
        with open(root / "modelnet40_test_16pts_fps.dat", "wb") as f:
            pickle.dump((pts, [np.asarray([i % 3], np.int32) for i in range(4)]), f)
        return {"DATA_PATH": str(root), "N_POINTS": 16, "subset": "test"}
    if name == "ModelNetFewShot":
        (root / "5way_10shot").mkdir()
        data = {"test": [(rng.normal(size=(16, 3)), i % 5) for i in range(6)]}
        with open(root / "5way_10shot" / "2.pkl", "wb") as f:
            pickle.dump(data, f)
        return {"DATA_PATH": str(root), "fold": 2, "subset": "test"}
    if name in ("ShapeNetClass",):
        return dict(_npy_tree(root, cols=3), subset="test")
    if name == "Objaverse_8192":
        (root / "a" / "b").mkdir(parents=True)
        for i in range(3):
            np.save(root / ("a" if i else "a/b") / f"o{i}.npy", rng.normal(size=(20, 3)))
        return {"DATA_PATH": str(root)}
    if name == "ScanNet":
        for i in range(3):
            np.save(root / f"s{i}.npy", rng.normal(size=(30 + 10 * i, 6)))
        (root / "scannet_medium.json").write_text(json.dumps([f"s{i}.npy" for i in range(3)]))
        return {"DATA_PATH": str(root), "N_POINTS": 35}
    for cname in ("chair", "plant", "sofa"):                  # the DG npy domains
        (root / cname / "train").mkdir(parents=True)
        for i in range(2):
            np.save(root / cname / "train" / f"{i}.npy", rng.normal(size=(40, 3)))
    return {"DATA_PATH": str(root), "N_POINTS": 24, "subset": "train"}


@pytest.mark.parametrize("name", ["ModelNet", "ModelNet_Official", "ModelNetFewShot",
                                  "ShapeNetClass", "Objaverse_8192", "ScanNet",
                                  "Modelnet40_DG", "Shapenet_DG"])
def test_reader_parity(tmp_path, name):
    cfg = dict(_reader_files(name, tmp_path), NAME=name)
    t, j = _both(cfg)
    assert len(t) == len(j) > 0
    for i in range(len(t)):
        np.random.seed(i)
        a = t[i]
        np.random.seed(i)
        _same(a, j[i])


def test_every_jax_reader_is_registered():
    from point_dae_tpu.utils.registry import DATASETS as JDATASETS

    assert sorted(DATASETS.keys()) == sorted(JDATASETS.keys())


def test_modelnet_cache_build_matches_jax(tmp_path):
    """The offline-FPS cache from the txt layout: the port's FPS (on the
    CPU here) picks the JAX package's points."""
    rng = np.random.default_rng(4)
    (tmp_path / "modelnet40_shape_names.txt").write_text("chair\nnight_stand\n")
    ids = ["chair_0001", "night_stand_0002"]
    (tmp_path / "modelnet40_test.txt").write_text("\n".join(ids) + "\n")
    for sid in ids:
        cname = "_".join(sid.split("_")[:-1])
        (tmp_path / cname).mkdir()
        np.savetxt(tmp_path / cname / f"{sid}.txt", rng.normal(size=(40, 6)), delimiter=",")
    cfg = {"NAME": "ModelNet", "DATA_PATH": str(tmp_path), "N_POINTS": 16,
           "subset": "test", "USE_NORMALS": True}
    t = tds.build_dataset_from_cfg(cfg, device="cpu")
    os.remove(tmp_path / "modelnet40_test_16pts_fps.dat")
    j = jds.build_dataset_from_cfg(cfg)
    for i in range(2):
        _same(t[i], j[i])


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_equal_jax(drop_last):
    t, j = _both(SYN)
    a = DataLoader(t, 5, shuffle=True, drop_last=drop_last, seed=4)
    b = JDataLoader(j, 5, shuffle=True, drop_last=drop_last, seed=4)
    assert len(a) == len(b) == (2 if drop_last else 3)
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        got, want = list(a), list(b)
        assert len(got) == len(want) == len(a)
        for x, y in zip(got, want):
            _same(x, y)
    assert [x["model_id"].tolist() for x in got] != \
        [x["model_id"].tolist() for x in list(DataLoader(t, 5, seed=4, drop_last=drop_last))]


def test_loader_raises_a_read_error():
    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError(f"cannot read {i}")

    with pytest.raises(OSError, match="cannot read"):
        list(DataLoader(Bad(), 2))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_device_cache_serves_each_row_once(dtype):
    from point_dae_tpu.data.device_cache import DeviceCache as JDeviceCache

    t = tds.build_dataset_from_cfg(dict(SYN, size=13))
    cache = build_device_cache(t, dtype=DTYPES[dtype], seed=2, device="cpu")
    assert cache.data.dtype == DTYPES[dtype] and cache.data.shape == (13, 64, 6)
    jc = JDeviceCache(np.zeros((13, 2, 3), np.float32))
    assert cache.steps_per_epoch(4) == jc.steps_per_epoch(4) == 3
    src = torch.from_numpy(np.stack([t[i]["points"] for i in range(13)]))
    orders = []
    for epoch in (0, 1):
        cache.set_epoch(epoch)
        assert sorted(cache.perm.tolist()) == list(range(13))
        rows = []
        for step in range(cache.steps_per_epoch(4)):
            b = cache.batch(step, 4)
            assert b.dtype == torch.float32 and b.shape == (4, 64, 6)
            idx = cache.perm[step * 4:(step + 1) * 4]
            assert torch.equal(b, src[idx].to(DTYPES[dtype]).float())
            rows += idx.tolist()
        assert len(set(rows)) == 12
        orders.append(cache.perm.tolist())
    assert orders[0] != orders[1]
    cache.set_epoch(0)
    assert cache.perm.tolist() == orders[0]


def test_device_cache_refuses_above_budget():
    t = tds.build_dataset_from_cfg(SYN)
    with pytest.raises(ValueError, match="device_cache_max_bytes"):
        build_device_cache(t, max_bytes=1000, device="cpu")


def test_transforms_follow_their_contracts():
    g = torch.Generator().manual_seed(0)
    pts = torch.randn(3, 50, 3, generator=g)

    def again(fn, **kw):
        a = fn(pts, torch.Generator().manual_seed(1), **kw)
        b = fn(pts, torch.Generator().manual_seed(1), **kw)
        assert torch.equal(a, b) and a.shape == pts.shape
        return a

    r = again(transforms.pointcloud_rotate)
    torch.testing.assert_close(r.norm(dim=-1), pts.norm(dim=-1))
    torch.testing.assert_close(r[..., 1], pts[..., 1])          # about the y axis
    j = again(transforms.pointcloud_jitter)
    assert float((j - pts).abs().max()) <= 0.05 + 1e-6
    s = again(transforms.pointcloud_scale)
    ratio = s / pts
    assert float(ratio.min()) >= 2 / 3 - 1e-5 and float(ratio.max()) <= 1.5 + 1e-5
    d = again(transforms.pointcloud_translate) - pts
    assert float(d.abs().max()) <= 0.2 and torch.allclose(d, d[:, :1])
    again(transforms.pointcloud_scale_and_translate)
    f = again(transforms.random_horizontal_flip)
    assert torch.equal(f[..., 2], pts[..., 2]) and torch.equal(f.abs(), pts.abs())
    dr = again(transforms.random_input_dropout)
    assert bool(((dr == pts) | (dr == pts[:, :1])).all())
