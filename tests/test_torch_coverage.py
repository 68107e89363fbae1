"""Which shipped pretrain configs of the two largest model families
(``Point_CAE_DGCNN_FCOnly`` and ``PointCAE_transformer_fc_global_folding_local``)
the port refuses: for each distinct (model, propagated ``model.corrupt_type``,
train ``corrupt_type``, ``aug_type``), the port's cloud corruption,
augmentation and (for the transformer) patch corruption raise
NotImplementedError exactly where the JAX package's do. The JAX side is
traced only (``jax.eval_shape`` on tiny arrays)."""
import functools
import glob
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from point_dae_tpu.data import corruptions as jc
from point_dae_tpu.data import corruptions_patch as jcp

from point_dae_torch.data import corruptions as tc
from point_dae_torch.data import corruptions_patch as tcp
from point_dae_torch.utils.config import cfg_from_yaml_file, propagate_corrupt_type

from _torch_files import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DGCNN, FLAGSHIP = "Point_CAE_DGCNN_FCOnly", "PointCAE_transformer_fc_global_folding_local"
N, B, G, S = 32, 2, 4, 8


def _shipped():
    """{(model, model corrupt_type, train corrupt_type, aug_type): configs}."""
    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "cfgs", "**", "*.yaml"), recursive=True)):
        cfg = cfg_from_yaml_file(path)
        model = cfg.get("model") or {}
        if model.get("NAME") not in (DGCNN, FLAGSHIP) or "pretrain" not in path:
            continue
        cfg = propagate_corrupt_type(cfg)
        train = cfg["dataset"]["train"]["others"]
        key = (model["NAME"], tuple(cfg["model"].get("corrupt_type") or ()),
               tuple(train.get("corrupt_type", ("clean",))),
               tuple(train.get("aug_type", ("norm",))))
        out.setdefault(key, []).append(os.path.basename(path))
    return out


SHIPPED = _shipped()


def _refuses(fn) -> bool:
    try:
        fn()
    except NotImplementedError:
        return True
    return False


@functools.lru_cache(maxsize=None)
def _jax_refuses(kind: str, types: tuple) -> bool:
    key = jax.random.key(0)
    if kind == "cloud":
        fn = lambda p: jc.corrupt_cloud(key, p, types)
        args = (jnp.zeros((N, 3)),)
    elif kind == "augment":
        fn = lambda p: jc.augment_cloud(key, p, types)
        args = (jnp.zeros((N, 3)),)
    else:
        fn = lambda n, c: jcp.corrupt_patches(key, n, c, types)
        args = (jnp.zeros((B, G, S, 3)), jnp.zeros((B, G, 3)))
    return _refuses(lambda: jax.eval_shape(fn, *args))


@functools.lru_cache(maxsize=None)
def _port_refuses(kind: str, types: tuple) -> bool:
    g = torch.Generator().manual_seed(0)
    if kind == "cloud":
        return _refuses(lambda: tc.corrupt_batch(torch.zeros((B, N, 3)), types, generator=g))
    if kind == "augment":
        return _refuses(lambda: tc.augment_batch(torch.zeros((B, N, 3)), types, generator=g))
    return _refuses(lambda: tcp.corrupt_patches(torch.zeros((B, G, S, 3)),
                                                torch.zeros((B, G, 3)), types, generator=g))


def test_shipped_configs_found():
    n = {m: sum(len(v) for k, v in SHIPPED.items() if k[0] == m) for m in (DGCNN, FLAGSHIP)}
    assert n == {DGCNN: 275, FLAGSHIP: 151}, n


@pytest.mark.parametrize("key", sorted(SHIPPED), ids=lambda k: "|".join(
    ["dgcnn" if k[0] == DGCNN else "flagship"] + ["+".join(t) or "-" for t in k[1:]]))
def test_port_refuses_exactly_where_jax_does(key):
    model, model_types, train_types, aug_types = key
    kinds = [("cloud", train_types), ("augment", aug_types)]
    if model == FLAGSHIP:
        kinds.append(("patch", model_types))
    for kind, types in kinds:
        assert _port_refuses(kind, types) == _jax_refuses(kind, types), (kind, types,
                                                                          SHIPPED[key][:3])
