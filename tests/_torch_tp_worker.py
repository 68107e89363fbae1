"""Worker of tests/test_torch_tensor_parallel.py: the port under a 2-D gloo
process layout on the CPU (tensor parallelism, ``get_mesh_2d`` and
``shard_params``). It imports the port only.

    python _torch_tp_worker.py <rank> <world> <store file> <inputs .pt> <out .pt> <exp dir> [fault]

World 1 runs with no process group; world 4 forms the group from a
``FileStore`` (``file://``) and lays it out as 2 data x 2 model ranks. The
inputs file holds the configuration, two global raw batches and one step's
draws replayed from the JAX keys. Phases, each recorded for the test:

- ``steps``: two f32 steps of the tiny flagship from one seed, the draws
  from a generator seeded alike on every rank (each data rank its rows),
  under a global-norm clip: the losses, the clip's norm, the whole
  parameters after each step (``gather_params``) and the rank's own
  tensors after the last;
- ``checkpoint``: ``save_checkpoint`` under the mesh, then
  ``resume_checkpoint`` into a fresh sharded state, whose tensors must be
  the saved state's bit for bit;
- ``remat``: step 1 again with ``remat`` on (the blocks recomputed in the
  backward, collectives included);
- ``jax_draws``: one step with the JAX keys' draws (this data rank's rows).

``fault`` breaks the layout on purpose: ``no_reduce`` drops the sum over
the model group after each row-split product.
"""
import os
import sys


def main():
    rank, world, store, infile, outfile, expdir = (int(sys.argv[1]), int(sys.argv[2]),
                                                   *sys.argv[3:7])
    fault = sys.argv[7] if len(sys.argv) > 7 else None
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    from point_dae_torch.engine.pretrain import init_model, make_train_step, sample_step_draws
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.models import layers
    from point_dae_torch.parallel import (destroy, gather_params, get_mesh, get_mesh_2d,
                                          initialize_distributed, local_rows, shard_params)
    from point_dae_torch.parallel.mesh import _batch_dims, _take
    from point_dae_torch.utils.checkpoint import resume_checkpoint, save_checkpoint
    from point_dae_torch.utils.config import ConfigDict

    if world > 1:
        initialize_distributed(init_method=f"file://{store}", num_processes=world,
                               process_id=rank, device="cpu", timeout_s=60)
        get_mesh_2d(model_parallel=2)
    mesh = get_mesh()
    if fault == "no_reduce":
        layers.reduce_from_model = lambda x, mesh_: x
    elif fault is not None:
        raise ValueError(f"fault {fault!r}")
    inputs = torch.load(infile, weights_only=False)
    cfg = ConfigDict(inputs["config"])
    raws = [r[local_rows(mesh, r.shape[0])] for r in inputs["raw"]]
    out = {"rank": rank, "world": world, "global_rank": mesh.global_rank,
           "data": (mesh.world, mesh.rank), "model": (mesh.model_world, mesh.model_rank)}

    def build(config):
        model = shard_params(mesh, init_model(config, seed=0, device="cpu"))
        return model, TrainState.create(model, config, 10, grad_norm_clip=inputs["clip"])

    # --- two steps ---------------------------------------------------------
    model, state = build(cfg)
    step = make_train_step(model, cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    out["losses"], out["norms"], out["whole"] = [], [], []
    for raw in raws:
        m = step(state, raw, generator=gen)
        out["losses"].append([float(m["loss_xyz"]), float(m["loss_normal"])])
        out["norms"].append(float(state.grad_norm))
        whole = gather_params(mesh, model)
        if mesh.model_rank == 0:
            out["whole"].append({k: v.clone() for k, v in whole.items()})
    out["local"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["shards"] = sorted(n for n, p in model.named_parameters()
                           if getattr(p, "tp_dim", None) is not None)

    # --- checkpoint: full tensors written, the shards read back -------------
    save_checkpoint(expdir, "ckpt-tp", state, epoch=0, best_metric=0.0)
    model2, state2 = build(cfg)
    resume_checkpoint(expdir, state2, name="ckpt-tp")
    sd, sd2 = model.state_dict(), model2.state_dict()
    o1, o2 = state.optimizer.state_dict()["state"], state2.optimizer.state_dict()["state"]
    out["resumed_equal"] = (all(torch.equal(sd[k], sd2[k]) for k in sd)
                            and state2.step == state.step and o1.keys() == o2.keys()
                            and all(torch.equal(o1[i][k], o2[i][k]) for i in o1 for k in o1[i]))
    del model2, state2

    # --- remat: step 1 with the blocks recomputed in the backward -----------
    rcfg = ConfigDict(inputs["config"])
    rcfg["model"]["transformer_config"]["remat"] = True
    model, state = build(rcfg)
    m = make_train_step(model, rcfg, device="cpu")(state, raws[0],
                                                    generator=torch.Generator().manual_seed(3))
    out["remat_loss"] = [float(m["loss_xyz"]), float(m["loss_normal"])]
    whole = gather_params(mesh, model)      # collective: every rank gathers
    out["remat_whole"] = whole if mesh.model_rank == 0 else None

    # --- one step with the JAX keys' draws: this data rank's rows -----------
    model, state = build(cfg)
    d = cfg["dataset"]["train"]["others"]
    raw = inputs["jax_raw"]
    B, n = raw.shape[:2]

    def sample(b):
        return sample_step_draws(model, tuple(d["aug_type"]), tuple(d["corrupt_type"]),
                                 int(d["npoints"]), b, n, torch.Generator().manual_seed(0),
                                 "cpu")

    rows = local_rows(mesh, B)
    draws = _take(inputs["jax_draws"], _batch_dims(sample(B), sample(B + 1)), rows)
    m = make_train_step(model, cfg, device="cpu")(state, raw[rows], draws=draws)
    out["jax_draws_loss"] = [float(m["loss_xyz"]), float(m["loss_normal"])]

    # --- gather_params(shard_params(model)) for each model of the zoo -------
    from point_dae_torch.models import build_model_from_cfg

    out["zoo"] = {}
    for name, mcfg in inputs["zoo"].items():
        zm = build_model_from_cfg(ConfigDict(mcfg), device="cpu", seed=0)
        sd = {k: v.clone() for k, v in zm.state_dict().items()}
        shard_params(mesh, zm)
        whole = gather_params(mesh, zm)
        qkv = {k: v.clone() for k, v in zm.state_dict().items() if k.endswith("attn.qkv.weight")}
        out["zoo"][name] = {"equal": sd.keys() == whole.keys() and all(
            torch.equal(sd[k], whole[k]) for k in sd), "qkv": qkv,
            "split": sum(getattr(p, "tp_dim", None) is not None for p in zm.parameters())}

    # --- the three autograd functions against their plain formulas ----------
    from point_dae_torch.parallel.mesh import copy_to_model, gather_from_model, reduce_from_model

    tp, r = mesh.model_world, mesh.model_rank

    def seeded(i, shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(100 + i))

    x = seeded(0, (3, 5)).requires_grad_(True)
    y = copy_to_model(x, mesh)
    y.backward(seeded(1 + r, (3, 5)))
    f = {"copy_fwd": torch.equal(y, x),
         "copy_bwd": float((x.grad - sum(seeded(1 + i, (3, 5)) for i in range(tp))).abs().max())}
    x = seeded(10 + r, (3, 5)).requires_grad_(True)
    y = reduce_from_model(x, mesh)
    g = seeded(20, (3, 5))
    y.backward(g)
    f["reduce_fwd"] = float((y.detach() - sum(seeded(10 + i, (3, 5)) for i in range(tp))).abs().max())
    f["reduce_bwd"] = torch.equal(x.grad, g)
    whole_w, whole_b = seeded(30, (8, 4)), seeded(31, (8,))
    w = torch.nn.Parameter(whole_w.reshape(2, tp, 4 // tp, 4)[:, r].reshape(-1, 4)
                           if tp > 1 else whole_w.clone())
    b = torch.nn.Parameter(whole_b[r * 8 // tp:(r + 1) * 8 // tp].clone())
    if tp > 1:
        w.tp_dim, w.tp_chunks, b.tp_dim, b.tp_chunks = 0, 2, 0, 1
    gw, gb = gather_from_model(mesh, [w, b])
    cot = seeded(32, (8, 4))
    ((gw * cot).sum() + (gb * gb).sum()).backward()
    f["gather_fwd"] = torch.equal(gw, whole_w) and torch.equal(gb, whole_b)
    want_w = cot.reshape(2, tp, 4 // tp, 4)[:, r].reshape(-1, 4) if tp > 1 else cot
    f["gather_bwd"] = (torch.equal(w.grad, want_w)
                       and torch.equal(b.grad, 2 * whole_b[r * 8 // tp:(r + 1) * 8 // tp]))
    out["functions"] = f

    torch.save(out, outfile + ".tmp")
    os.replace(outfile + ".tmp", outfile)
    destroy()


if __name__ == "__main__":
    main()
