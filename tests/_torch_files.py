"""Small data trees on disk for the port's data and run tests, and the
intra-op thread setting of the port's test modules."""
import json

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a test module's CPU ops. Its tensors are
    small, and the suite runs six workers on the host's cores: there the
    default of a thread a core oversubscribes them (60 forwards of a tiny
    DGCNN took 3.3 s on one thread and 46.8 s on eight, alone, and 6 s
    against 170 s with six such processes side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SEG_PARTS = {"Airplane": [0, 1, 2, 3], "Mug": [36, 37]}


def partseg_tree(root, per_cat=3, rows=40):
    """A ShapeNetPart tree: the category file (one category the reader skips),
    the split lists and ``per_cat`` txt clouds of x y z nx ny nz part a
    category, split train / val / test in turn."""
    rng = np.random.default_rng(5)
    cats = {"Airplane": "02691156", "Mug": "03797390", "Unknown": "09999999"}
    (root / "synsetoffset2category.txt").write_text(
        "".join(f"{n}\t{s}\n" for n, s in cats.items()))
    (root / "train_test_split").mkdir()
    ids = {"train": [], "val": [], "test": []}
    for name, synset in cats.items():
        (root / synset).mkdir()
        parts = SEG_PARTS.get(name, [0])
        for i in range(per_cat):
            sid = f"{name.lower()}{i:02d}"
            data = np.concatenate([rng.normal(size=(rows, 6)),
                                   rng.choice(parts, (rows, 1))], 1)
            np.savetxt(root / synset / f"{sid}.txt", data)
            ids[("train", "val", "test")[i % 3]].append(f"shape_data/{synset}/{sid}")
    for split, lst in ids.items():
        (root / "train_test_split" / f"shuffled_{split}_file_list.json").write_text(
            json.dumps(lst))
    return {"NAME": "ShapeNetPart", "DATA_PATH": str(root)}
