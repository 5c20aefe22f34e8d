"""``ModelConfig.remat`` in the port: per-layer activation checkpointing.

With dropout, activation dropout and drop-path on (attention dropout too on
the XLA branch), the port's joint loss and every gradient under ``remat``
equal, bit for bit, its own without it: the recompute replays the forward's
masks from the generator. With dropout off, the port under ``remat`` matches
the JAX package's ``jax.value_and_grad`` of ``multitask_loss`` with
``remat=True`` (the JAX XLA branch, compiled once) on the same parameters
and batches: the loss and per-task metrics to 1e-5 relative, each gradient
leaf to 5e-4 of its largest |g| (``test_torch_port_train``'s bounds, with
its floor for the key biases). ``ofa_tiny`` cut to 2 + 2 layers, ResNet
(1, 1, 1), 64² images, float32, one intra-op thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu import config as jc
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.training import TaskBatch as JaxTaskBatch
from musketeer_tpu.training.train_step import multitask_loss as jax_multitask_loss
from musketeer_tpu_torch import config as tc
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.params import from_jax, trainable
from musketeer_tpu_torch.training import TaskBatch
from musketeer_tpu_torch.training.train_state import named_leaves
from musketeer_tpu_torch.training.train_step import multitask_loss
from tests.test_torch_port_model import _randomize
from tests.test_torch_port_normformer import one_thread  # noqa: F401  (autouse fixture)

CRIT = dict(label_smoothing=0.1, use_rdrop=True)
RATES = dict(dropout=0.1, activation_dropout=0.1, encoder_drop_path_rate=0.1,
             decoder_drop_path_rate=0.1)


def _np_batch(rs, B, Ts, Tt, img=False):
    tgt = rs.randint(4, 1000, (B, Tt)).astype(np.int32)
    tgt[0, -2:] = 1
    prev = np.roll(tgt, 1, 1)
    prev[:, 0] = 0
    b = dict(src_tokens=rs.randint(4, 1000, (B, Ts)).astype(np.int32),
             prev_output_tokens=prev, target=tgt)
    if img:
        b["patch_images"] = rs.rand(B, 64, 64, 3).astype(np.float32)
        b["patch_masks"] = np.ones(B, bool)
    return b


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jc.ofa_tiny(), dtype="float32", use_flash_attention=False,
                                encoder_layers=2, decoder_layers=2, resnet_layers=(1, 1, 1))
    params = jax.jit(jofa.init_ofa_params, static_argnums=1)(jax.random.PRNGKey(0), cfg_j)
    params_np = _randomize(jax.tree.map(np.array, params), np.random.RandomState(7))
    rs = np.random.RandomState(3)
    nb = {"caption": _np_batch(rs, 2, 8, 5, img=True), "gigaword": _np_batch(rs, 2, 10, 5),
          "infill": _np_batch(rs, 2, 10, 5)}
    return dict(cfg_j=cfg_j, params_np=params_np, nb=nb)


def _torch_batches(nb):
    t = lambda a: torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
    return {n: TaskBatch(**{k: t(v) for k, v in b.items()}) for n, b in nb.items()}


def _port(setup, flash: bool, remat: bool, rates: dict, seed=5):
    """The port's multitask loss, metrics and gradients (``named_leaves`` order)."""
    cfg = tc.ModelConfig(**dataclasses.asdict(dataclasses.replace(
        setup["cfg_j"], use_flash_attention=flash, remat=remat, **rates)))
    params = trainable(from_jax(setup["params_np"], cfg, "cpu", torch.float32))
    calls = ofa.xla_attention.calls
    loss, metrics = multitask_loss(params, cfg, tc.CriterionConfig(**CRIT),
                                   _torch_batches(setup["nb"]), torch.Generator().manual_seed(seed),
                                   0)
    forward_calls = ofa.xla_attention.calls - calls
    loss.backward()
    return dict(loss=loss.detach(), metrics={k: v.detach() for k, v in metrics.items()},
                grads=[(path, p.grad) for path, p in named_leaves(params)],
                xla_calls=(forward_calls, ofa.xla_attention.calls - calls))


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "xla"])
def test_remat_leaves_loss_and_gradients_equal_with_dropout(setup, flash):
    rates = dict(RATES, attention_dropout=0.0 if flash else 0.1)
    plain = _port(setup, flash, False, rates)
    remat = _port(setup, flash, True, rates)
    assert torch.equal(plain["loss"], remat["loss"])
    for k, v in plain["metrics"].items():
        assert torch.equal(v, remat["metrics"][k]), k
    for (path, a), (_, b) in zip(plain["grads"], remat["grads"]):
        assert (a is None) == (b is None), path
        if a is not None:
            assert torch.equal(a, b), path
    # the masks are really drawn: another seed gives another loss
    assert not torch.equal(_port(setup, flash, True, rates, seed=6)["loss"], plain["loss"])
    if not flash:  # every layer's attentions run again in the backward
        assert plain["xla_calls"][1] == plain["xla_calls"][0]
        assert remat["xla_calls"][1] == 2 * remat["xla_calls"][0]


@pytest.fixture(scope="module")
def jax_remat(setup):
    cfg_j = dataclasses.replace(setup["cfg_j"], remat=True)
    batches = {n: JaxTaskBatch(**{k: jnp.asarray(v) for k, v in b.items()})
               for n, b in setup["nb"].items()}

    def f(p):
        return jax_multitask_loss(p, cfg_j, jc.CriterionConfig(**CRIT), batches,
                                  jax.random.PRNGKey(0), jnp.int32(0))

    (loss, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, setup["params_np"]))
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    return dict(loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
                grads=named_leaves(from_jax(jax.tree.map(np.asarray, grads), cfg_t, "cpu",
                                            torch.float32)))


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "xla"])
def test_remat_matches_jax_remat(setup, jax_remat, flash):
    port = _port(setup, flash, True, {})
    ref = jax_remat
    assert abs(float(port["loss"]) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for k, v in ref["metrics"].items():
        assert abs(float(port["metrics"][k]) - v) <= 1e-5 * max(abs(v), 1e-12), k
    floor = 1e-4 * max(float(g.abs().max()) for _, g in ref["grads"])
    for (path, gt), (_, gj) in zip(port["grads"], ref["grads"]):
        scale = max(float(gj.abs().max()), floor)
        gt = torch.zeros_like(gj) if gt is None else gt
        assert float((gt - gj).abs().max()) <= 5e-4 * scale, path
