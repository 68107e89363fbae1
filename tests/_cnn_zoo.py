"""Shared pieces of the CNN zoo's parity tests (``test_torch_dae_pointnet.py``,
``test_torch_dae_zoo.py``): every case of a file goes through the JAX
package in one jitted function (one XLA compile for all its classes), with
the port's weights carried across by ``to_flax``, and the port runs the
same case on the CPU.

A case is (key, NAME, kind, train): ``pretrain`` (the two losses and the
gradient of their sum), ``head`` (the logits and the gradient of a
cross-entropy), ``feat`` (the features); ``grads`` False runs a case's
forward alone. Each port model's BatchNorm running statistics are moved
off their initial values first, so that an eval-mode case reads them. The
heads' dropout keep masks are fed to flax through ``intercept_methods`` by
module name, the in-model dropouts' draws through a fixed key
(``CORRUPT_KEY``) that the JAX ``apply_input_dropout`` is patched to
take."""
import dataclasses
from typing import Dict, Sequence

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.models import build_model_from_cfg as j_build
from point_dae_tpu.models import common as jcommon
from point_dae_tpu.utils.config import ConfigDict as JConfigDict

from point_dae_torch.models import MODELS
from point_dae_torch.models.common import DropoutDraws
from point_dae_torch.utils.config import ConfigDict
from point_dae_torch.utils.convert import _flatten, to_flax

CORRUPT_KEY = 7


@dataclasses.dataclass
class Case:
    key: str
    name: str
    kind: str                        # pretrain, head or feat
    train: bool = True
    cfg: Dict = dataclasses.field(default_factory=dict)
    tol: float = 1e-5                # of the output, relative (arrays: to the largest)
    grads: bool = True               # hold the gradients


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def port_model(case: Case, seed: int):
    """The port model on the CPU, built on the meta device and given weights
    drawn from ``seed`` (a Dense kernel N(0, 1 / fan_in), a norm's scale 1 +
    N(0, 0.01), a bias N(0, 0.0025)) and running statistics off their
    initial values: both packages read the same weights whatever their
    draw, and these cost a fraction of the initialisers' draws."""
    with torch.device("meta"):
        model = MODELS.build(ConfigDict(dict(case.cfg, NAME=case.name)))
    model = model.to_empty(device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            p.copy_(r / p.shape[1] ** 0.5 if p.dim() >= 2 else
                    1.0 + 0.1 * r if n.endswith("weight") else 0.05 * r)
        for n, b in model.named_buffers():
            if n.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
            elif n.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
    return model


def global_dropout_draws(batch: int, n: int, keep_n: int) -> DropoutDraws:
    """``dropout_global``'s draws from ``fold_in(CORRUPT_KEY, 0)``, as the
    JAX ``apply_input_dropout`` draws them for the first item."""
    k_m, k_rs = jax.random.split(jax.random.fold_in(jax.random.key(CORRUPT_KEY), 0))
    r = jax.random.uniform(k_m, (batch, n))
    draw = jax.random.randint(k_rs, (batch, n), 0, jnp.full((batch, 1), keep_n))
    return DropoutDraws(resample=t(draw), rank_u=t(r))


def _ce(logits, labels):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], -1))


def run_jax(cases: Sequence[Case], weights, inputs, masks, modules=()):
    """{key: (output, flat gradients or None, flat new running statistics
    or None)} of every case in one jit. ``weights[key]`` = (params, stats);
    ``inputs[key]``: ``x`` (corrupted, or the classified cloud), ``y``
    (clean), ``labels``; ``masks[key]``: the dropout keep masks by flax
    module name; ``modules``: JAX model modules whose
    ``apply_input_dropout`` is patched to take ``CORRUPT_KEY``. A case whose
    gradients are not held runs its forward alone."""
    models = {c.key: j_build(JConfigDict(dict(c.cfg, NAME=c.name))) for c in cases}
    tracing = {}

    def one(c, params, stats, inp):
        m, x, y = models[c.key], inp["x"], inp["y"]
        tracing["masks"] = masks.get(c.key, {})
        rngs = {"dropout": jax.random.key(0), "corrupt": jax.random.key(1)}
        if c.kind == "feat":
            return m.apply({"params": params, "batch_stats": stats}, x, train=False), None, None

        def loss_fn(p):
            v = {"params": p, "batch_stats": stats}
            args = (x, y) if c.kind == "pretrain" else (x,)
            if c.train:
                out, upd = m.apply(v, *args, train=True, rngs=rngs, mutable=["batch_stats"])
                new = upd["batch_stats"]
            else:
                out, new = m.apply(v, *args, train=False, rngs=rngs), None
            loss = out[0] + out[1] if c.kind == "pretrain" else _ce(out, inp["labels"])
            return loss, (out, new)

        if not c.grads:
            return loss_fn(params)[1] + (None,)
        (_, (out, new)), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return out, g, new

    def fn(weights, inputs):
        return {c.key: one(c, *weights[c.key], inputs[c.key]) for c in cases}

    def fixed_dropout(key, pts, corrupt_type):
        return jcommon.apply_input_dropout(jax.random.key(CORRUPT_KEY), pts, corrupt_type)

    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"
                and not kwargs.get("deterministic", mod.deterministic)):
            keep = jnp.asarray(tracing["masks"][mod.name])
            return jnp.where(keep, args[0] / (1.0 - mod.rate), 0.0)
        return next_fun(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp, fnn.intercept_methods(intercept):
        for mod in modules:
            mp.setattr(mod, "apply_input_dropout", fixed_dropout)
        res = jax.jit(fn)(weights, {c.key: {k: jnp.asarray(v) for k, v in inputs[c.key].items()}
                                    for c in cases})
    res = jax.device_get(res)
    flat = lambda tree: None if tree is None else _flatten(
        jax.tree_util.tree_map(np.asarray, tree))
    return {k: (jax.tree_util.tree_map(np.asarray, o), flat(g), flat(s))
            for k, (o, g, s) in res.items()}


def run_port(case: Case, model, inputs, draws=None):
    """(output, flat gradients or None, flat running statistics after the
    forward) of the port on the same case (``inputs`` the case's);
    ``draws``: the model's (``DropoutDraws`` list of a DAE, ``ClsDraws`` of
    a head). A parameter no loss reaches counts a zero gradient, as JAX
    gives it."""
    x, y = t(inputs["x"]), t(inputs["y"])
    model.zero_grad(set_to_none=True)
    if case.kind == "feat":
        with torch.no_grad():
            return model.eval()(x).numpy(), None, None
    model.train(case.train)
    with torch.set_grad_enabled(case.grads):
        if case.kind == "pretrain":
            out = model(x, y, draws=draws)
            loss = out[0] + out[1]
        else:
            out = model(x, draws=draws)
            logp = torch.log_softmax(out, -1)
            loss = -logp.gather(-1, t(inputs["labels"]).long()[:, None]).mean()
    stats = _flatten(to_flax(model.state_dict())[1]) if case.train else None
    if not case.grads:
        out = [o.numpy() for o in out] if case.kind == "pretrain" else out.numpy()
        return (np.array([float(out[0]), float(out[1])]) if case.kind == "pretrain" else out,
                None, stats)
    loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    gt = _flatten(to_flax(grads)[0])
    if case.kind == "pretrain":
        return np.array([float(out[0].detach()), float(out[1].detach())]), gt, stats
    return out.detach().numpy(), gt, stats


def bn_fed_biases(flat_params) -> set:
    """The bias leaves of Dense layers that feed a BatchNorm (``x_fc`` /
    ``x_bn``, ``fcN`` / ``bnN``, ``convN`` / ``bnN``): in train mode their
    gradient is zero but for rounding."""
    out = set()
    for k in flat_params:
        head, _, leaf = k.rpartition("/")
        if leaf != "bias":
            continue
        mod, _, name = head.rpartition("/")
        for bn in {name.replace("_fc", "_bn"), name.replace("fc", "bn"),
                   name.replace("conv", "bn")} - {name}:
            if f"{mod}/{bn}/scale" in flat_params:
                out.add(k)
    return out


def grad_close(got: np.ndarray, want: np.ndarray, top: float) -> bool:
    """Every element within 1e-4 of the leaf's largest (or 1e-6 of the
    model's largest gradient ``top``, for a leaf of rounding noise), as
    ``test_torch_masksurf.py`` holds gradients; else, where f32 rounding
    settles a near-tie apart in the two packages (a nearest neighbour among
    a folding decoder's close points, a max-pool's maximum, a ReLU gate)
    and sends a few elements' gradient elsewhere, the leaf's difference
    within 1e-2 of its norm and no element off by 2e-2 of its largest (the
    worst such leaf here, the MA2E folding head's first layer in eval mode:
    2.2e-3 of its norm, 4.9e-3 of its largest)."""
    err, scale = np.abs(got - want), np.abs(want).max()
    if err.max() <= max(1e-4 * scale, 1e-6 * top):
        return True
    return (np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
            and err.max() <= 2e-2 * scale)


def compare(case: Case, got, want):
    """Losses, logits and features within ``case.tol`` relative (arrays: of
    their largest); every gradient by ``grad_close``, but in train mode the
    biases before a BatchNorm, whose gradient is zero but for rounding (eval
    mode holds them); the new running statistics within 1e-5 relative."""
    (go, gg, gs), (wo, wg, ws) = got, want
    wo = np.array([float(wo[0]), float(wo[1])]) if case.kind == "pretrain" else np.asarray(wo)
    assert np.isfinite(go).all() and go.shape == wo.shape, (case.key, go.shape, wo.shape)
    if case.kind == "pretrain":
        np.testing.assert_allclose(go, wo, rtol=case.tol, atol=0, err_msg=case.key)
    else:
        np.testing.assert_allclose(go, wo, rtol=0, atol=case.tol * np.abs(wo).max(),
                                   err_msg=case.key)
    if case.grads and case.kind != "feat":
        assert set(gg) == set(wg), (case.key, sorted(set(gg) ^ set(wg)))
        top = max(np.abs(g).max() for g in wg.values())
        bad = [k for k in sorted(set(wg) - (bn_fed_biases(wg) if case.train else set()))
               if not grad_close(gg[k], wg[k], top)]
        assert not bad, (case.key, [(k, float(np.abs(gg[k] - wg[k]).max()),
                                     float(np.abs(wg[k]).max())) for k in bad[:4]])
    if ws is not None:
        assert set(gs) == set(ws), case.key
        for k in ws:
            np.testing.assert_allclose(gs[k], ws[k], rtol=1e-5,
                                       atol=1e-5 * np.abs(ws[k]).max(),
                                       err_msg=f"{case.key} {k}")
