"""The port's tensor parallelism (``point_dae_torch/parallel/mesh.py``:
``get_mesh_2d``, ``param_spec``, ``shard_params``) against the JAX
package's and against one process.

- ``param_spec`` gives the torch dimension of the JAX ``param_spec``'s split
  on every flax path of three models (the flagship at ``_tiny_config``,
  Point_MAE, MaskSurf), and ``shard_plan`` splits what the JAX
  ``shard_params`` splits under ``get_mesh_2d(model_parallel=2)`` on the 8
  CPU devices, but for the one stated difference: a block whose head count
  the model axis does not divide keeps its attention whole in the port.
- ``tests/_torch_tp_worker.py`` runs 4 gloo ranks on the CPU, 2 data x 2
  model, beside one process with no group (a ``FileStore`` in ``tmp_path``,
  a 60 s group timeout, 180 s a process), two f32 steps of the tiny
  flagship (the plain route) from the same weights and draws: losses
  within 1e-6 relative at step 1 and 5e-6 at step 2 (measured 1.2e-7 and
  7.8e-7: the row-split products sum in another order), the whole
  parameters (``gather_params``) after each step within 1e-5 absolute (1% of
  one AdamW step at lr 1e-3; measured 3.3e-6) but the three BatchNorm-fed
  biases, whose true gradient is zero and which the flagship parity test
  holds to AdamW's bound (``tests/test_torch_flagship.py:_NULL_GRAD``), and
  the running statistics within 1e-4 (the batch mean carries those
  biases' differences: 1.3e-5 measured). The replicated tensors are bit
  for bit equal on all four ranks, each model rank's shards on its two data
  ranks, the clip's norm on every rank; a checkpoint saved under the mesh
  has the one-process layout and loads into one process; ``remat`` under
  the mesh gives the step without it bit for bit. One step with the JAX
  keys' draws is held to the JAX ``make_train_step`` under
  ``get_mesh_2d(model_parallel=2)`` + ``shard_params`` within 1e-4
  relative (the flagship parity test's f32 bound).

A planted fault, ``reduce_from_model`` dropped (the worker's ``no_reduce``),
read once on the CPU: step-1 loss_xyz 5.505 on model rank 0 and 1.817 on
model rank 1 against one process's 1.920, whole parameters up to 2.0e-3
apart after step 1 (two AdamW steps), the two model ranks' replicated
tensors and clip norms apart (132.6 and 126.5 against 48.1); the loss,
parameter, rank-equality, norm and resume checks fail.
"""
import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_files import one_torch_thread  # noqa: F401

from __graft_entry__ import _tiny_config
from point_dae_tpu.data import corruptions_patch as jcp
from point_dae_tpu.engine.pretrain import make_train_step as j_make_train_step
from point_dae_tpu.engine.train_state import (TrainState as JTrainState,
                                              build_optimizer as j_build_optimizer)
from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import layers as jlayers
from point_dae_tpu.models import transformer as jtr
from point_dae_tpu.parallel import get_mesh_2d as j_get_mesh_2d
from point_dae_tpu.parallel import mesh as jmesh
from point_dae_tpu.parallel import shard_params as j_shard_params
from point_dae_tpu.parallel.mesh import replicate as j_replicate, shard_batch as j_shard_batch
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.data.corruptions_patch import AffineR3Draws
from point_dae_torch.engine.pretrain import PipelineDraws, StepDraws
from point_dae_torch.models import build_model_from_cfg
from point_dae_torch.models.transformer import ModelDraws
from point_dae_torch.parallel import Mesh, get_mesh, get_mesh_2d, param_spec, shard_params
from point_dae_torch.parallel.mesh import shard_plan, split_shard
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, flax_paths, to_flax
from test_torch_flagship import B, NRAW, _draws, _pipeline_draws

WORKER = os.path.join(os.path.dirname(__file__), "_torch_tp_worker.py")
CLIP = 0.05          # below the steps' norms (48 and 12.6): the clip acts
NULL_GRAD = ("MAE_encoder.encoder.first_conv.0.bias", "MAE_encoder.encoder.first_conv.3.bias",
             "MAE_encoder.encoder.second_conv.0.bias")
LR = 1e-3


def _tfm(**kw):
    return dict({"rand_ratio": "False", "mask_ratio": 0.6, "mask_type": "rand",
                 "trans_dim": 32, "encoder_dims": 32, "depth": 2, "drop_path_rate": 0.1,
                 "num_heads": 2, "decoder_depth": 1, "decoder_num_heads": 2}, **kw)


def _flagship_cfg():
    cfg = _tiny_config()
    del cfg["model"]["transformer_config"]["dtype"]      # f32: the plain route
    return cfg


ZOO = {
    "flagship": _flagship_cfg()["model"],
    "point_mae": {"NAME": "Point_MAE", "corrupt_type": ["Drop-Patch"], "group_size": 8,
                  "num_group": 16, "loss": "cdl2", "transformer_config": _tfm(mask_type="block")},
    "masksurf": {"NAME": "MaskSurf", "corrupt_type": ["clean"], "all_patch": "False",
                 "group_size": 8, "num_group": 16, "loss": "cdl2normal",
                 "transformer_config": _tfm()},
}


def _model(name, **tfm):
    cfg = copy.deepcopy(ZOO[name])
    cfg["transformer_config"].update(tfm)
    return build_model_from_cfg(ConfigDict(cfg), device="cpu", seed=0)


def _torch_dim(spec, ndim):
    """The torch dimension of a JAX PartitionSpec's 'model' axis (a flax
    kernel (in, out) is a torch weight (out, in)); None for P()."""
    axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    if not axes:
        return None
    return ndim - 1 - axes[0] if ndim == 2 else axes[0]


@pytest.mark.parametrize("name", sorted(ZOO))
def test_param_spec_matches_jax_on_every_flax_path(name):
    params, _ = to_flax(_model(name).state_dict())
    split = 0
    for path, v in _flatten(params).items():
        want = _torch_dim(jmesh.param_spec(path, v.ndim), v.ndim)
        assert param_spec(path, v.ndim) == want, path
        split += want is not None
    assert split >= 5 * 3, split       # qkv, proj, fc1 (kernel, bias), fc2 a block


def _decisions(model):
    """(port, JAX) split dimension of every torch parameter at a model axis
    of 2: the port's ``shard_plan`` and the JAX ``shard_params``'s
    placement of the ``to_flax`` tree on the 8 CPU devices."""
    named = dict(model.named_parameters())
    paths = flax_paths(list(named))
    params, _ = to_flax(model.state_dict())
    mesh2 = j_get_mesh_2d(model_parallel=2)
    assert dict(mesh2.shape) == {"data": 4, "model": 2}
    placed = _flatten(jax.tree_util.tree_map(
        lambda x: x.sharding.spec, j_shard_params(mesh2, params),
        is_leaf=lambda x: hasattr(x, "sharding")))
    plan = shard_plan(model, 2)
    port, jax_ = {}, {}
    for n, p in named.items():
        leaf = "bias" if n.endswith("bias") else "kernel" if p.dim() == 2 else "scale"
        spec = placed.get(f"{paths[n]}/{leaf}")
        if spec is None:                # not a Dense or LayerNorm leaf
            continue
        port[n] = plan[n][0] if n in plan else None
        jax_[n] = _torch_dim(spec, p.dim())
    return port, jax_


@pytest.mark.parametrize("name", sorted(ZOO))
def test_shard_decisions_match_jax(name):
    """Every parameter the JAX ``shard_params`` splits the port splits, in
    the same dimension, and nothing else; ``qkv`` in 3 chunks (q, k, v),
    split alike."""
    port, jax_ = _decisions(_model(name))
    assert port == jax_
    assert sum(v is not None for v in port.values()) >= 15
    plan = shard_plan(_model(name), 2)
    assert {n: c for n, (_, c) in plan.items() if c != 1} == {
        n: 3 for n in plan if n.endswith("attn.qkv.weight")}


def test_shard_decisions_where_heads_do_not_divide():
    """The one stated difference: with 3 heads a block (48 wide) the JAX
    package splits ``qkv`` by its 144 columns and ``proj`` by its rows
    all the same (GSPMD reshards around the heads); the port keeps each
    block's attention whole and splits its MLP as JAX does."""
    port, jax_ = _decisions(_model("point_mae", trans_dim=48, encoder_dims=48, num_heads=3,
                                   decoder_num_heads=3))
    attn = {n for n in port if ".attn.qkv." in n or ".attn.proj." in n}
    assert {n for n in attn if jax_[n] is not None} == {n for n in attn if "weight" in n}
    assert all(port[n] is None for n in attn)
    assert {n: v for n, v in port.items() if n not in attn} == \
        {n: v for n, v in jax_.items() if n not in attn}
    assert any(v is not None for v in port.values())


def test_split_shard_takes_each_ranks_heads():
    """Rank r's shard of a (3C, C) ``qkv`` weight holds the q, k and v rows
    of heads [rH/tp, (r + 1)H/tp), in that order: the rows the attention
    reads as (B, N, 3, H / tp, d)."""
    H, d, C, tp = 4, 3, 12, 2
    w = torch.arange(3 * C * C, dtype=torch.float32).reshape(3 * C, C)
    for r in range(tp):
        want = w.reshape(3, H, d, C)[:, r * H // tp:(r + 1) * H // tp].reshape(-1, C)
        assert torch.equal(split_shard(w, 0, 3, tp, r), want)
    proj = torch.arange(C * C, dtype=torch.float32).reshape(C, C)
    assert torch.equal(split_shard(proj, 1, 1, tp, 1), proj[:, C // 2:])


def test_one_process_mesh_is_unchanged():
    """Without a process group ``get_mesh_2d(1)`` is the 1-D mesh, and
    ``shard_params`` leaves a model as it is; a 2-D ``Mesh``'s global rank
    and main process follow the (data, model) layout."""
    assert get_mesh_2d(1) == get_mesh() == Mesh()
    model = _model("point_mae")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert shard_params(get_mesh(), model) is model
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert not any(hasattr(p, "tp_dim") for p in model.parameters())
    assert [Mesh(2, r // 2, model_world=2, model_rank=r % 2).global_rank
            for r in range(4)] == [0, 1, 2, 3]
    assert [Mesh(2, r // 2, model_world=2, model_rank=r % 2).is_main
            for r in range(4)] == [True, False, False, False]
    with pytest.raises(ValueError, match="process group"):
        get_mesh_2d(2)


def _jax_draws():
    """One step's draws from JAX keys (the flagship parity test's): the
    pipeline's resample indices, the patch mask, affine_r3's parameters
    and the encoder's stochastic-depth masks."""
    cfg = _flagship_cfg()
    rng = np.random.default_rng(7)
    raw = rng.normal(size=(B, NRAW, 6)).astype(np.float32)
    mask, affine, dp_enc = _draws(cfg, rng)
    key = jax.random.key(11)
    pipe = _pipeline_draws(key, cfg["dataset"]["train"]["others"]["npoints"])
    count, perm, A, bvec, m = affine
    draws = StepDraws(
        PipelineDraws(torch.tensor(pipe[0]).long(), torch.tensor(pipe[1]).long()),
        ModelDraws(torch.from_numpy(mask),
                   [AffineR3Draws(count, perm.tolist(), torch.tensor(A), torch.tensor(bvec),
                                  torch.tensor(m)), None],
                   torch.from_numpy(dp_enc), None))
    return raw, key, (mask, affine, dp_enc), draws


def _jax_tp_step(raw, key, jdraws, init):
    """The JAX step under ``get_mesh_2d(model_parallel=2)`` + ``shard_params``
    from the port's initial weights (``to_flax``), the draws fed through
    monkeypatch as ``tests/test_torch_flagship.py:_run_jax`` feeds them."""
    mask, (count, perm, A, bvec, m), dp_enc = jdraws

    def corrupt(key_, neigh, center, types, fix_translate_bug=False):
        assert tuple(types) == ("affine_r3", "Drop-Patch")
        return jcp._apply_affine_r3((jnp.int32(count), jnp.asarray(perm), jnp.asarray(A),
                                     jnp.asarray(bvec), jnp.asarray(m)), neigh, center)

    def dp_masks(mod, dpr, batch, deterministic):
        if deterministic or max(dpr) == 0.0:
            return None
        assert len(dpr) == dp_enc.shape[0]
        return jnp.asarray(dp_enc)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "sample_patch_mask", lambda *a, **k: jnp.asarray(mask))
        mp.setattr(jtr, "corrupt_patches", corrupt)
        mp.setattr(jlayers, "_stack_dp_masks", dp_masks)
        config = JConfigDict(_flagship_cfg())
        model = j_build(config["model"])
        params, stats = init
        tx, _ = j_build_optimizer(config, params, steps_per_epoch=10)
        mesh2 = j_get_mesh_2d(model_parallel=2)
        p2 = j_shard_params(mesh2, params)
        state = JTrainState.create(model.apply, p2, j_replicate(mesh2, stats), tx)
        step = j_make_train_step(model, config, mesh2)
        _, metrics = step(state, j_shard_batch(mesh2, jnp.asarray(raw)), key, jnp.float32(0.0))
        return {k: float(v) for k, v in jax.device_get(metrics).items()}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """One process with no group and 4 gloo ranks (2 data x 2 model), side by
    side; the JAX 2-D-mesh step runs here meanwhile. Returns (one process's
    record, the four ranks' records, the JAX metrics, the run's
    directory)."""
    tmp = tmp_path_factory.mktemp("torch_tp")
    cfg = _flagship_cfg()
    rng = np.random.default_rng(3)
    raws = [torch.from_numpy(rng.normal(size=(B, NRAW, 6)).astype(np.float32))
            for _ in range(2)]
    jraw, key, jdraws, draws = _jax_draws()
    zoo = {k: copy.deepcopy(v) for k, v in ZOO.items()}
    torch.save({"config": cfg, "raw": raws, "clip": CLIP, "jax_raw": torch.from_numpy(jraw),
                "jax_draws": draws, "zoo": zoo}, tmp / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs, outs = [], []
    for world, rank in ((1, 0), (4, 0), (4, 1), (4, 2), (4, 3), (2, 0), (2, 1)):
        exp = tmp / f"exp_{world}"
        exp.mkdir(exist_ok=True)
        outs.append(tmp / f"out_{world}_{rank}.pt")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(rank), str(world), str(tmp / f"store_{world}"),
             str(tmp / "in.pt"), str(outs[-1]), str(exp)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        from point_dae_torch.engine.pretrain import init_model

        init = to_flax(init_model(ConfigDict(cfg), seed=0, device="cpu").state_dict())
        jm = _jax_tp_step(jraw, key, jdraws, init)
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    recs = [torch.load(o, weights_only=False) for o in outs]
    return recs[0], recs[1:5], jm, tmp, recs[5:]


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))


def test_layout_is_jax_reshape(layouts):
    """Rank g at data rank g // 2 and model rank g % 2 (JAX's
    ``devices.reshape(n / tp, tp)``): model groups [0, 1], [2, 3], data
    groups [0, 2], [1, 3]."""
    _, ranks, _, _, _ = layouts
    assert [(r["global_rank"], r["data"], r["model"]) for r in ranks] == [
        (g, (2, g // 2), (2, g % 2)) for g in range(4)]


def test_two_steps_match_one_process(layouts):
    one, ranks, _, _, _ = layouts
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
    assert _rel(ranks[0]["losses"][0], one["losses"][0]).max() <= 1e-6
    assert _rel(ranks[0]["losses"][1], one["losses"][1]).max() <= 5e-6
    for s in range(2):
        whole, want = ranks[0]["whole"][s], one["whole"][s]
        assert whole.keys() == want.keys()
        for k, v in want.items():
            got = whole[k]
            assert got.shape == v.shape, k
            if k in NULL_GRAD:      # AdamW's bound: at most lr a step each way
                assert float((got - v).abs().max()) <= 2 * LR * (s + 1) * (1 + 1e-4), k
            elif "running_" in k:
                assert float((got - v).abs().max()) <= 1e-4, k
            elif v.dtype.is_floating_point:
                assert float((got - v).abs().max()) <= 1e-5, k
            else:
                assert torch.equal(got, v), k
    # something moved, and the blocks' tensors were split
    assert len(ranks[0]["shards"]) == 15


def test_model_axis_alone_matches_one_process(layouts):
    """tp 2 x dp 1: both ranks hold the whole batch and report the same
    losses and clip norms, hold the same replicated tensors, and match one
    process within the 4-rank bounds."""
    one, _, _, _, duo = layouts
    assert [(r["data"], r["model"]) for r in duo] == [((1, 0), (2, 0)), ((1, 0), (2, 1))]
    assert duo[0]["losses"] == duo[1]["losses"] and duo[0]["norms"] == duo[1]["norms"]
    for s, tol in enumerate((1e-6, 5e-6)):
        assert _rel(duo[0]["losses"][s], one["losses"][s]).max() <= tol
        assert _rel(duo[0]["norms"][s], one["norms"][s]) <= tol
    shards = set(duo[0]["shards"])
    for k, v in duo[0]["local"].items():
        if k not in shards:
            assert torch.equal(v, duo[1]["local"][k]), k
    for k, v in one["whole"][1].items():
        if k not in NULL_GRAD and "running_" not in k and v.dtype.is_floating_point:
            assert float((duo[0]["whole"][1][k] - v).abs().max()) <= 1e-5, k


def test_replicated_tensors_equal_on_every_rank(layouts):
    _, ranks, _, _, _ = layouts
    shards = set(ranks[0]["shards"])
    local = [r["local"] for r in ranks]
    for k in local[0]:
        if k not in shards:
            for lo in local[1:]:
                assert torch.equal(lo[k], local[0][k]), k


def test_shards_equal_on_each_model_ranks_data_ranks(layouts):
    """Global ranks 0 and 2 hold model rank 0's shards, 1 and 3 model
    rank 1's: each pair bit for bit, the two model ranks' apart."""
    _, ranks, _, _, _ = layouts
    local = [r["local"] for r in ranks]
    for k in ranks[0]["shards"]:
        assert 2 * local[0][k].numel() == ranks[0]["whole"][1][k].numel(), k
        assert torch.equal(local[0][k], local[2][k]), k
        assert torch.equal(local[1][k], local[3][k]), k
        assert not torch.equal(local[0][k], local[1][k]), k


def test_clip_norm_equal_on_every_rank(layouts):
    """The global norm of the whole parameters (shards' squares summed over
    the model group, replicated ones once): equal on every rank, and one
    process's within the steps' loss bounds."""
    one, ranks, _, _, _ = layouts
    for r in ranks:
        assert r["norms"] == ranks[0]["norms"]
    assert min(ranks[0]["norms"]) > CLIP
    assert _rel(ranks[0]["norms"][0], one["norms"][0]) <= 1e-6
    assert _rel(ranks[0]["norms"][1], one["norms"][1]) <= 5e-6


def test_checkpoint_under_the_mesh_loads_into_one_process(layouts):
    """``save_checkpoint`` under the mesh writes whole tensors (global rank
    0 alone), which load into a one-process model and optimizer; resumed
    under the mesh, every rank gets its shards and moments back bit for
    bit. The gathered AdamW moments are one process's, parameter by
    parameter: each within 1e-4 of its largest value (1.3e-5 measured), the
    BatchNorm-fed biases' (rounding noise) below 1e-3 of the model's largest
    moment (1.4e-7 measured); two same-shaped parameters' moments swapped
    would be O(1) apart."""
    from point_dae_torch.engine.pretrain import init_model
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.utils.checkpoint import load_params, resume_checkpoint

    one, ranks, _, tmp, _ = layouts
    assert all(r["resumed_equal"] for r in ranks) and one["resumed_equal"]
    sd = load_params(str(tmp / "exp_4"), "ckpt-tp")
    whole = ranks[0]["whole"][1]
    assert sd.keys() == whole.keys()
    assert all(torch.equal(sd[k], whole[k]) for k in sd)
    cfg = ConfigDict(_flagship_cfg())
    model = init_model(cfg, seed=0, device="cpu")
    state = TrainState.create(model, cfg, 10)
    resume_checkpoint(str(tmp / "exp_4"), state, name="ckpt-tp")
    assert state.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, whole[k]), k
    moments = state.optimizer.state_dict()["state"]
    ref = torch.load(tmp / "exp_1" / "ckpt-tp.pth", weights_only=True)["optimizer"]["state"]
    by_id = {id(p): n for n, p in model.named_parameters()}
    names = [by_id[id(p)] for g in state.optimizer.param_groups for p in g["params"]]
    assert moments.keys() == ref.keys()
    top = {k: max(float(e[k].abs().max()) for e in ref.values()) for k in ("exp_avg", "exp_avg_sq")}
    for i, entry in ref.items():
        for k, v in entry.items():
            got = moments[i][k]
            assert got.shape == v.shape, (names[i], k)
            if v.dim() == 0:
                assert torch.equal(got, v), (names[i], k)
            elif names[i] in NULL_GRAD:     # rounding noise on both sides
                assert max(float(got.abs().max()), float(v.abs().max())) <= 1e-3 * top[k], k
            else:
                assert float((got - v).abs().max()) <= 1e-4 * float(v.abs().max()), (names[i], k)


def test_remat_under_the_mesh_recomputes_the_step(layouts):
    """``remat`` with a model group: each block's forward runs again in the
    backward, its collectives with it; step 1 is the step without it, bit
    for bit (loss and every whole parameter)."""
    _, ranks, _, _, _ = layouts
    for r in ranks:
        assert r["remat_loss"] == r["losses"][0]
    got, want = ranks[0]["remat_whole"], ranks[0]["whole"][0]
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_loss_matches_jax_two_dim_mesh(layouts):
    """One step from the same weights and the JAX keys' draws: the 4 ranks'
    losses against the JAX step under ``get_mesh_2d(model_parallel=2)`` +
    ``shard_params`` (data 4 x model 2 on 8 CPU devices) within 1e-4
    relative, and against one process within 1e-6."""
    one, ranks, jm, _, _ = layouts
    for r in ranks:
        assert r["jax_draws_loss"] == ranks[0]["jax_draws_loss"]
    got = ranks[0]["jax_draws_loss"]
    np.testing.assert_allclose(got, [jm["loss_xyz"], jm["loss_normal"]], rtol=1e-4)
    assert _rel(got, one["jax_draws_loss"]).max() <= 1e-6


@pytest.mark.parametrize("name", sorted(ZOO))
def test_gather_of_shards_is_the_model(layouts, name):
    """``gather_params(shard_params(model))`` is the model's state dict bit
    for bit on every rank, and each model rank's ``qkv`` shard holds its
    heads' q, k and v rows."""
    _, ranks, _, _, _ = layouts
    model = _model(name) if name != "flagship" else build_model_from_cfg(
        ConfigDict(copy.deepcopy(ZOO[name])), device="cpu", seed=0)
    sd = model.state_dict()
    heads = {n: m.attn.num_heads for n, m in model.named_modules() if hasattr(m, "attn")}
    for r in ranks:
        rec = r["zoo"][name]
        assert rec["equal"] and rec["split"] == 15
        for k, shard in rec["qkv"].items():
            H = heads[k[:-len(".attn.qkv.weight")]]
            C = sd[k].shape[1]
            want = sd[k].reshape(3, H, C // H, C)[:, r["model"][1] * H // 2:
                                                   (r["model"][1] + 1) * H // 2].reshape(-1, C)
            assert torch.equal(shard, want), k


@pytest.mark.parametrize("fn", ["copy", "reduce", "gather"])
def test_autograd_function_matches_formula(layouts, fn):
    """On every rank: ``copy_to_model`` is the identity forward and sums the
    model group's gradients backward; ``reduce_from_model`` sums forward and
    passes the gradient backward; ``gather_from_model`` (a weight split in
    2 chunks and a bias) is the whole tensors forward and this rank's slice
    of the whole gradient backward, bit for bit. The sums are held within
    1e-6 of the plain formula's (0 measured: sums of two f32 terms)."""
    one, ranks, _, _, _ = layouts
    for r in ranks + [one]:
        f = r["functions"]
        for v in (f[f"{fn}_fwd"], f[f"{fn}_bwd"]):
            assert v is True if isinstance(v, bool) else v <= 1e-6, (r["rank"], f)
