"""Worker of tests/test_torch_parallel.py: the port under a gloo process
group on the CPU (``tests/_multihost_worker.py``'s counterpart). It imports
the port only.

    python _torch_parallel_worker.py <rank> <world> <store file> <out json> <exp dir> [fault]

World 1 runs with no process group, as a user's one-process run does; world
2 forms the group from a ``FileStore`` (``file://``). Every phase records
what the test holds the two layouts to: BatchNorm (the layer and the fused
EdgeConv's statistics) and ``masked_chamfer_l2`` with unequal masks a rank
(outputs, running statistics, gradients); two DGCNN steps (the global
batches' hashes and the losses); ``run_pretrain`` end to end (step, probe
accuracy, a parameter digest); two steps from the device cache; two tiny
flagship steps; a fine-tune model's eval and vote accuracy; one epoch of
``run_finetune`` with its validation.

``fault`` breaks the group on purpose, to read how far what the test
holds moves under a real fault: ``local_stats`` keeps BatchNorm's
statistics to each rank's rows, ``no_allreduce`` drops the gradient
all-reduce.
"""
import hashlib
import json
import os
import sys
from types import SimpleNamespace


def _synthetic(size, seed=0, npoints=64, corrupt=("affine_r3",)):
    return {"_base_": {"NAME": "Synthetic", "N_POINTS": 256, "num_classes": 4,
                       "with_normal": True},
            "others": {"subset": "train", "npoints": npoints, "aug_type": ["norm"],
                       "corrupt_type": list(corrupt), "size": size, "seed": seed}}


def main():
    rank, world, store, outfile, expdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                           sys.argv[4], sys.argv[5])
    fault = sys.argv[6] if len(sys.argv) > 6 else None
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from point_dae_torch.data.datasets import build_dataset_from_cfg
    from point_dae_torch.data.device_cache import build_device_cache
    from point_dae_torch.data.loader import DataLoader
    from point_dae_torch.engine.finetune import (evaluate, make_eval_step, make_vote_step,
                                                 run_finetune, vote_eval)
    from point_dae_torch.engine.pretrain import init_model, make_train_step, run_pretrain
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.losses.chamfer import masked_chamfer_l2
    from point_dae_torch.models import build_model_from_cfg
    from point_dae_torch.models.dgcnn import fused_edge_conv
    from point_dae_torch.models.layers import BatchNorm, Dense
    from point_dae_torch.parallel import (all_gather_rows, all_reduce_gradients, destroy,
                                          get_mesh, initialize_distributed,
                                          loader_shard_kwargs, pad_to_batch,
                                          shard_batch, sharded_eval)
    from point_dae_torch.utils.config import ConfigDict

    if world > 1:
        initialize_distributed(init_method=f"file://{store}", num_processes=world,
                               process_id=rank, device="cpu", timeout_s=60)
    mesh = get_mesh()
    out = {"rank": rank, "world": world}
    if fault == "local_stats":
        from point_dae_torch.models import dgcnn, layers
        from point_dae_torch.parallel import Mesh

        layers.get_mesh = dgcnn.get_mesh = Mesh
    elif fault == "no_allreduce":
        from point_dae_torch.engine import train_state

        train_state.all_reduce_gradients = lambda params, mesh: None
    elif fault is not None:
        raise ValueError(f"fault {fault!r}")

    def digest(t):
        return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()

    # --- batch-wide statistics: each rank its rows of one global batch ---
    rng = np.random.default_rng(0)
    x_full = torch.from_numpy(rng.normal(size=(8, 5, 6)).astype(np.float32))
    coef = torch.from_numpy(rng.normal(size=(8, 5, 6)).astype(np.float32))
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, 6))
    x = shard_batch(mesh, x_full).clone().requires_grad_(True)
    y = bn(x)
    # each rank's loss is its rows' mean, so the global loss is the ranks' mean
    (y * shard_batch(mesh, coef)).sum(-1).mean().backward()
    all_reduce_gradients(list(bn.parameters()), mesh)
    out["bn"] = {"y": all_gather_rows(mesh, y.detach()).tolist(),
                 "x_grad": (all_gather_rows(mesh, x.grad) / mesh.world).tolist(),
                 "w_grad": bn.weight.grad.tolist(), "b_grad": bn.bias.grad.tolist(),
                 "mean": bn.running_mean.tolist(), "var": bn.running_var.tolist()}

    pts_full = torch.from_numpy(rng.normal(size=(4, 32, 3)).astype(np.float32))
    conv = Dense(6, 8, bias=False, generator=torch.Generator().manual_seed(3))
    ebn = BatchNorm(8)
    p = shard_batch(mesh, pts_full).clone().requires_grad_(True)
    e = fused_edge_conv(p, conv, ebn, 6, None, use_pallas=False)
    e.square().mean().backward()
    all_reduce_gradients(list(conv.parameters()) + list(ebn.parameters()), mesh)
    out["edge_bn"] = {"y": all_gather_rows(mesh, e.detach()).tolist(),
                      "x_grad": (all_gather_rows(mesh, p.grad) / mesh.world).tolist(),
                      "w_grad": conv.weight.grad.tolist(),
                      "mean": ebn.running_mean.tolist(), "var": ebn.running_var.tolist()}

    a_full = torch.from_numpy(rng.normal(size=(8, 16, 3)).astype(np.float32))
    b_full = torch.from_numpy(rng.normal(size=(8, 16, 3)).astype(np.float32))
    w_full = torch.tensor([1., 1., 1., 0., 1., 0., 0., 0.])   # 3 sets on rank 0, 1 on 1
    a = shard_batch(mesh, a_full).clone().requires_grad_(True)
    loss = masked_chamfer_l2(a, shard_batch(mesh, b_full), shard_batch(mesh, w_full))
    loss.backward()
    out["chamfer"] = {"loss": float(loss),
                      "grad": (all_gather_rows(mesh, a.grad) / mesh.world).tolist()}

    # --- two DGCNN steps: the port's building blocks --------------------
    cfg = ConfigDict({
        "optimizer": {"type": "AdamW", "part": "all",
                      "kwargs": {"lr": 0.001, "weight_decay": 0.05}},
        "scheduler": {"type": "CosLR", "kwargs": {"epochs": 1, "initial_epochs": 0}},
        "dataset": {"train": _synthetic(32), "val": _synthetic(16, 1),
                    "extra_train": _synthetic(16, 2)},
        "model": {"NAME": "Point_CAE_DGCNN_FCOnly", "corrupt_type": [], "loss": "cdl2"},
        "normal_weight": 1.0, "total_bs": 8, "max_epoch": 0, "loss_type": "xyz"})
    ds = build_dataset_from_cfg(cfg["dataset"]["train"]["_base_"],
                                cfg["dataset"]["train"]["others"], device="cpu")
    loader = DataLoader(ds, 8 // mesh.world, shuffle=True, seed=0,
                        **loader_shard_kwargs(mesh))
    model = init_model(cfg, seed=0, device="cpu")
    state = TrainState.create(model, cfg, len(loader))
    step = make_train_step(model, cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    hashes, losses = [], []
    for bi, batch in enumerate(loader):
        if bi >= 2:
            break
        raw = torch.from_numpy(batch["points"])
        hashes.append(digest(all_gather_rows(mesh, raw)))
        losses.append(float(step(state, raw, generator=gen)["loss_xyz"]))
    out.update(batch_hashes=hashes, probe_losses=losses)

    # --- run_pretrain end to end -----------------------------------------
    args = SimpleNamespace(seed=0, experiment_path=expdir, val_freq=1, resume=False,
                           start_ckpts=None, tfboard_path=None)
    run = run_pretrain(cfg, args, logger_name=f"tp_worker_{world}_{rank}", device="cpu")
    params = dict(run["state"].model.named_parameters())
    out.update(best_acc=float(run["best_acc"]), step=int(run["state"].step),
               digest={k: float(v.detach().abs().sum()) for k, v in params.items()},
               files=sorted(os.listdir(expdir)))

    # --- the device cache: each rank its block, one exact all-reduce -------
    cache = build_device_cache(ds, dtype=torch.float32, seed=0, device="cpu", mesh=mesh)
    cache.set_epoch(0)
    model = init_model(cfg, seed=0, device="cpu")
    state = TrainState.create(model, cfg, cache.steps_per_epoch(8))
    step = make_train_step(model, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    hashes, losses = [], []
    for i in range(2):
        raw = cache.batch(i, 8)
        hashes.append(digest(all_gather_rows(mesh, raw)))
        losses.append(float(step(state, raw, generator=gen)["loss_xyz"]))
    out.update(cache_hashes=hashes, cache_losses=losses, cache_rows=len(cache.data))

    # --- the tiny flagship (__graft_entry__.py's _tiny_config): masks,
    # patch corruptions, stochastic depth, bf16 products -------------------
    fcfg = ConfigDict({
        "optimizer": cfg["optimizer"], "scheduler": cfg["scheduler"],
        "dataset": {"train": _synthetic(16, npoints=128, corrupt=("clean",))},
        "model": {"NAME": "PointCAE_transformer_fc_global_folding_local",
                  "corrupt_type": ["affine_r3", "Drop-Patch"], "all_patch": "False",
                  "group_size": 8, "num_group": 16, "loss": "cdl2",
                  "transformer_config": {
                      "rand_ratio": "True", "mask_ratio": 0.6, "mask_type": "rand",
                      "trans_dim": 64, "encoder_dims": 64, "depth": 2,
                      "drop_path_rate": 0.1, "cls_dim": 55, "num_heads": 2,
                      "decoder_depth": 1, "decoder_num_heads": 2, "dtype": "bf16"}},
        "normal_weight": 0.005, "total_bs": 8, "max_epoch": 0, "loss_type": "xyznormal"})
    fds = build_dataset_from_cfg(fcfg["dataset"]["train"]["_base_"],
                                 fcfg["dataset"]["train"]["others"], device="cpu")
    floader = DataLoader(fds, 8 // mesh.world, shuffle=True, seed=0,
                         **loader_shard_kwargs(mesh))
    model = init_model(fcfg, seed=0, device="cpu")
    state = TrainState.create(model, fcfg, len(floader))
    step = make_train_step(model, fcfg, device="cpu")
    gen = torch.Generator().manual_seed(2)
    losses = []
    for batch in floader:
        m = step(state, torch.from_numpy(batch["points"]), generator=gen)
        losses.append([float(m["loss_xyz"]), float(m["loss_normal"])])
    out["flagship_losses"] = losses

    # --- a fine-tune model's eval and vote loops -------------------------
    ccfg = ConfigDict({"model": {"NAME": "DGCNN", "cls_dim": 4}, "npoints": 64})
    cls = build_model_from_cfg(ccfg["model"], device="cpu", seed=0)
    val = build_dataset_from_cfg(_synthetic(14, 3)["_base_"], _synthetic(14, 3)["others"],
                                 device="cpu")

    def batches():
        return DataLoader(val, 8, shuffle=False, drop_last=False)

    eval_step = make_eval_step(cls, ccfg, device="cpu")
    out["eval_acc"] = evaluate(eval_step, batches(), 8)
    out["eval_logits"] = torch.cat([
        sharded_eval(eval_step, torch.from_numpy(pad_to_batch(b["points"], 8)))
        for b in batches()]).tolist()
    out["vote_acc"] = vote_eval(make_vote_step(cls, ccfg, times=2, device="cpu"), batches(),
                                8, torch.Generator().manual_seed(4))

    # --- run_finetune: one epoch and its validation ------------------------
    tcfg = ConfigDict({
        "optimizer": cfg["optimizer"], "scheduler": cfg["scheduler"],
        "dataset": {"train": _synthetic(16, 5), "val": _synthetic(14, 3)},
        "model": {"NAME": "DGCNN", "cls_dim": 4}, "npoints": 64, "total_bs": 8,
        "max_epoch": 0, "grad_norm_clip": 10})
    targs = SimpleNamespace(seed=0, experiment_path=os.path.join(expdir, "ft"),
                            tfboard_path=None, ckpts=None)
    ft = run_finetune(tcfg, targs, logger_name=f"tp_ft_{world}_{rank}", device="cpu")
    out.update(ft_best_acc=float(ft["best_acc"]), ft_step=int(ft["state"].step),
               ft_digest={k: float(v.detach().abs().sum())
                          for k, v in ft["state"].model.named_parameters()})

    with open(outfile + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(outfile + ".tmp", outfile)
    destroy()


if __name__ == "__main__":
    main()
