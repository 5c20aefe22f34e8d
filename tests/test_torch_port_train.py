"""The port's joint training step against the JAX package's, on ``ofa_tiny``.

``ofa_tiny`` cut to 2 + 2 layers and ResNet (1, 1, 1), 64² images, float32,
all dropout rates 0 with ``deterministic=False`` (the training branch). Both
sides get the same parameters (the JAX init with random rel-pos tables and
BatchNorm statistics, bridged through ``from_jax`` and made trainable) and
the same numpy batches. The JAX attention runs its Pallas kernels in
interpret mode, the port's the plain versions of K3/K4. Each JAX program
compiles once: the joint step's gradients are read back from its Adam state.

Tolerances: forward logits to 1e-4 of their largest magnitude; every
gradient leaf, BatchNorm ``mean`` and ``var`` included, to 5e-4 of the
leaf's largest |g| (the bound of ``tests/test_flash_attention.py``; for
the key biases, whose exact gradient is zero, of 1e-4 of the tree's
largest |g|); losses,
per-task metrics and the gradient norm to 1e-5 relative; one optimizer
update to 1e-2·lr per element, plus, because Adam's first step divides each
clipped gradient ĝ by |ĝ| + eps, what a gradient difference of 1e-5 of the
leaf's largest |ĝ| (three times the worst seen) becomes through that
division: clipped at a norm of ~40 down to 0.1, many gradients land near
eps = 1e-8, where fp32 summation differences move the update by a few % of lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu import config as jc
from musketeer_tpu.criterions.label_smoothed_ce import label_smoothed_ce as jax_ce
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.training import TaskBatch as JaxTaskBatch
from musketeer_tpu.training import init_train_state as jax_init_state
from musketeer_tpu.training import make_train_step as jax_make_step
from musketeer_tpu.training.lr_schedule import polynomial_decay_schedule as jax_schedule
from musketeer_tpu.training.train_step import dequantize_batch as jax_dequantize
from musketeer_tpu_torch import config as tc
from musketeer_tpu_torch.criterions import label_smoothed_ce
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.params import from_jax, trainable
from musketeer_tpu_torch.training import TaskBatch, init_train_state, make_train_step
from musketeer_tpu_torch.training.lr_schedule import polynomial_decay_schedule
from musketeer_tpu_torch.training.train_state import named_leaves
from musketeer_tpu_torch.training.train_step import dequantize_batch, multitask_loss
from tests.test_torch_port_model import _randomize

UPDATE = 7000  # TrainState.step: drop-worst active
CRIT = dict(label_smoothing=0.1, use_rdrop=True, drop_worst_ratio=0.2, drop_worst_after=6000)
# warmup 0: lr(0) = lr, so the first update moves the parameters
OPTIM = dict(lr=1e-4, warmup_updates=0, total_updates=100)
GRAD_REL = 1e-5  # gradient agreement assumed by the update bound (worst seen: 3.1e-6)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _rel(a, b):
    a, b = float(np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)), float(b)
    return abs(a - b) / max(abs(b), 1e-12)


def _np_batch(rs, cfg, B, Ts, Tt, A=1, img=False, cm=False, conf=None):
    """A task batch in numpy with a leading accumulation axis A."""
    def one():
        tgt = rs.randint(4, 1000, (B, Tt)).astype(np.int32)
        tgt[:, -1] = cfg.eos
        tgt[0, -2:] = cfg.pad  # a padded target position
        prev = np.roll(tgt, 1, 1)
        prev[:, 0] = cfg.bos
        src = rs.randint(4, 1000, (B, Ts)).astype(np.int32)
        src[-1, -2:] = cfg.pad  # a padded source token
        b = dict(src_tokens=src, prev_output_tokens=prev, target=tgt)
        if img:
            b["patch_images"] = rs.rand(B, 64, 64, 3).astype(np.float32)
            b["patch_masks"] = np.ones(B, bool)
        if cm:
            m = rs.rand(B, Tt, cfg.padded_vocab_size) < 0.02
            m[..., cfg.vocab_size:] = False
            m[np.arange(B)[:, None], np.arange(Tt)[None], tgt] = True
            b["constraint_masks"] = m
        if conf is not None:
            b["conf"] = np.full(B, conf, np.float32)
        return b
    parts = [one() for _ in range(A)]
    return {k: np.stack([p[k] for p in parts]) for k in parts[0]}


def _jax_batches(nb):
    return {n: JaxTaskBatch(**{k: jnp.asarray(v) for k, v in b.items()}) for n, b in nb.items()}


def _torch_batches(nb):
    def t(a):
        x = torch.from_numpy(a)
        return x.long() if a.dtype == np.int32 else x
    return {n: TaskBatch(**{k: t(v) for k, v in b.items()}) for n, b in nb.items()}


def _micro(batches):
    return {n: type(b)(*[None if x is None else x[0] for x in b]) for n, b in batches.items()}


@pytest.fixture(scope="module")
def pair():
    cfg_j = dataclasses.replace(jc.ofa_tiny(), dtype="float32", use_flash_attention=True,
                                encoder_layers=2, decoder_layers=2, resnet_layers=(1, 1, 1))
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    params = jax.jit(jofa.init_ofa_params, static_argnums=1)(jax.random.PRNGKey(0), cfg_j)
    params_np = _randomize(jax.tree.map(np.array, params), np.random.RandomState(7))
    rs = np.random.RandomState(3)
    nb = {
        "caption": _np_batch(rs, cfg_j, 2, 8, 5, img=True, conf=2.0),
        "vqa": _np_batch(rs, cfg_j, 2, 7, 6, img=True, cm=True),
        "gigaword": _np_batch(rs, cfg_j, 2, 10, 5),
        "infill": _np_batch(rs, cfg_j, 2, 10, 5),  # packs with gigaword
    }
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_np=params_np,
                params_j=jax.tree.map(jnp.asarray, params_np), nb=nb)


def _params_t(pair):
    return trainable(from_jax(pair["params_np"], pair["cfg_t"], "cpu", torch.float32))


def test_trainable_tree_is_fp32_with_one_tied_embedding(pair):
    p = _params_t(pair)
    leaves = named_leaves(p)
    assert "embed_tokens_c" not in p
    assert all(t.dtype == torch.float32 and t.requires_grad and t.is_leaf for _, t in leaves)
    assert len({t.data_ptr() for _, t in leaves}) == len(leaves)  # no shared storage
    paths = {path for path, _ in leaves}
    assert {"encoder.resnet.layer1.first.bn1.mean", "encoder.layers.self_attn.q_proj.w",
            "decoder.layers.encoder_attn.out_proj.b"} <= paths
    # masters come from an fp32 tree, never from weights already rounded to bf16
    with pytest.raises(ValueError, match="fp32"):
        trainable(from_jax(pair["params_np"], pair["cfg_t"], "cpu", torch.bfloat16))


def test_training_forward_matches_jax(pair):
    """The forward a training step runs (deterministic=False, rates 0)."""
    b = {k: v[0] for k, v in pair["nb"]["vqa"].items()}
    fwd = jax.jit(jofa.forward, static_argnums=1, static_argnames="deterministic")
    ref = fwd(pair["params_j"], pair["cfg_j"], jnp.asarray(b["src_tokens"]),
              jnp.asarray(b["prev_output_tokens"]), jnp.asarray(b["patch_images"]),
              jnp.asarray(b["patch_masks"]), rngs=jax.random.PRNGKey(0), deterministic=False)
    out = ofa.forward(_params_t(pair), pair["cfg_t"], torch.from_numpy(b["src_tokens"]).long(),
                      torch.from_numpy(b["prev_output_tokens"]).long(),
                      torch.from_numpy(b["patch_images"]), torch.from_numpy(b["patch_masks"]),
                      generator=torch.Generator().manual_seed(0), deterministic=False)
    assert out.requires_grad and tuple(out.shape) == ref.shape
    V = pair["cfg_j"].vocab_size
    ref = np.asarray(ref)
    assert _err(out.detach().numpy()[..., :V], ref[..., :V]) <= 1e-4 * np.abs(ref[..., :V]).max()
    np.testing.assert_array_equal(out.detach().numpy()[..., V:], ref[..., V:])


@pytest.fixture(scope="module")
def losses_and_grads(pair, joint_step):
    """JAX: the joint step's loss metrics, and its gradients read back from its
    Adam state (the first moment is (1 − b1)·ĝ, with ĝ the gradient clipped at
    norm clip_norm); the port: ``multitask_loss`` and its backward."""
    cfg_t = pair["cfg_t"]
    st_j, m_j = joint_step[:2]
    mj = {k: v for k, v in m_j.items() if k.startswith(("loss/", "nll/"))}
    optim = jc.OptimConfig(**OPTIM)
    unclip = max(float(m_j["gnorm"]), optim.clip_norm) / optim.clip_norm
    mu = _adam_state(st_j).mu
    gj = jax.tree.map(lambda m: np.asarray(m) / (1 - optim.adam_b1) * unclip, mu)
    params_t = _params_t(pair)
    lt, mt = multitask_loss(params_t, cfg_t, tc.CriterionConfig(**CRIT),
                            _micro(_torch_batches(pair["nb"])), torch.Generator().manual_seed(0),
                            UPDATE)
    lt.backward()
    grads_j = named_leaves(from_jax(gj, cfg_t, "cpu", torch.float32))
    grads_t = [(path, p.grad) for path, p in named_leaves(params_t)]
    return dict(lj=mj["loss/total"], mj=mj, lt=lt, mt=mt, grads_j=grads_j, grads_t=grads_t)


def test_multitask_loss_matches_jax(losses_and_grads):
    r = losses_and_grads
    assert _rel(r["lt"], r["lj"]) <= 1e-5
    assert set(r["mt"]) == set(r["mj"])
    for k in r["mj"]:
        assert _rel(r["mt"][k], r["mj"][k]) <= 1e-5, k


def test_every_gradient_leaf_matches_jax(losses_and_grads):
    r = losses_and_grads
    assert [p for p, _ in r["grads_t"]] == [p for p, _ in r["grads_j"]]
    # the key biases shift every score of a row alike, so their exact gradient
    # is zero and both sides hold rounding noise: their scale is floored at
    # 1e-4 of the largest gradient in the tree
    floor = 1e-4 * max(float(np.abs(g.numpy()).max()) for _, g in r["grads_j"])
    checked = set()
    for (path, gt), (_, gj) in zip(r["grads_t"], r["grads_j"]):
        gj = gj.numpy()
        scale = max(float(np.abs(gj).max()), floor)
        gt = np.zeros_like(gj) if gt is None else gt.numpy()  # unused leaves: zero in JAX
        assert _err(gt, gj) <= 5e-4 * scale, f"{path}: {_err(gt, gj)} vs max |g| {scale}"
        if np.abs(gj).max() > floor:
            checked.add(path)
    # the frozen-BN statistics train in the JAX package, and so here
    assert "encoder.resnet.layer2.first.bn2.mean" in checked
    assert "encoder.resnet.bn1.var" in checked
    assert "decoder.token_rel_pos_table" in checked and "encoder.image_rel_pos_table" in checked


def _run_steps(pair, nb, crit, optim, update=UPDATE):
    """One make_train_step update on each side → (jax state, jax metrics, torch
    state, torch metrics, torch params before)."""
    cfg_j, cfg_t = pair["cfg_j"], pair["cfg_t"]
    st_j = jax_init_state(pair["params_j"], jc.OptimConfig(**optim))._replace(step=jnp.int32(update))
    step_j = jax_make_step(cfg_j, jc.CriterionConfig(**crit), jc.OptimConfig(**optim), donate=False)
    st_j, m_j = step_j(st_j, _jax_batches(nb), jax.random.PRNGKey(1))
    params_t = _params_t(pair)
    before = [p.detach().clone() for _, p in named_leaves(params_t)]
    st_t = init_train_state(params_t, tc.OptimConfig(**optim))._replace(step=update)
    step_t = make_train_step(cfg_t, tc.CriterionConfig(**crit), tc.OptimConfig(**optim))
    st_t, m_t = step_t(st_t, _torch_batches(nb), torch.Generator().manual_seed(1))
    return st_j, m_j, st_t, m_t, before


def _adam_state(state):
    """The ScaleByAdamState (count, mu, nu) inside a JAX TrainState's optax chain."""
    return next(s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                if hasattr(s, "mu"))


def _check_update(pair, st_j, m_j, st_t, m_t, before, lr):
    assert int(st_j.step) == st_t.step
    assert set(m_t) == set(m_j)
    for k in m_j:
        assert _rel(m_t[k], m_j[k]) <= 1e-5, k
    bridge = lambda tree: named_leaves(from_jax(jax.tree.map(np.asarray, tree), pair["cfg_t"],
                                                "cpu", torch.float32))
    after_j = bridge(st_j.params)
    # the clipped (and frozen) gradient JAX's Adam took: its first moment / (1 − b1)
    b1, eps = jc.OptimConfig().adam_b1, jc.OptimConfig().adam_eps
    ghat = [m.numpy() / (1 - b1) for _, m in bridge(_adam_state(st_j).mu)]
    moved = 0
    for (path, pt), (_, pj), p0, g in zip(named_leaves(st_t.params), after_j, before, ghat):
        dt, dj = (pt.detach() - p0).numpy(), (pj - p0).numpy()
        # Adam's first step moves a parameter by lr·ĝ/(|ĝ|+eps) (+ weight decay):
        # 1e-2·lr, plus what a gradient difference of GRAD_REL of the leaf's
        # largest |ĝ| becomes through that step's slope lr·eps/(|ĝ|+eps)²
        bound = lr * (1e-2 + GRAD_REL * np.abs(g).max() * eps / (np.abs(g) + eps) ** 2)
        excess = np.abs(dt - dj) - bound
        assert excess.max() <= 0, f"{path}: {_err(dt, dj)} at ĝ {g.flat[excess.argmax()]}"
        moved += int(np.abs(dj).max() > 0.5 * lr)
    return moved


@pytest.fixture(scope="module")
def joint_step(pair):
    return _run_steps(pair, pair["nb"], CRIT, OPTIM)


def test_joint_step_update_matches_jax(pair, joint_step):
    st_j, m_j, st_t, m_t, before = joint_step
    assert st_t.step == UPDATE + 1 and float(m_t["skipped_nonfinite"]) == 0.0
    assert st_t.opt_state["count"] == 1
    moved = _check_update(pair, st_j, m_j, st_t, m_t, before, OPTIM["lr"])
    assert moved > 100  # nearly every leaf moves by ~lr


@pytest.fixture(scope="module")
def variant_step(pair):
    """A = 2 (gradients summed over two microbatches, divided by 2) with the
    tied embedding frozen, on two text tasks that pack into one forward."""
    rs = np.random.RandomState(11)
    nb = {n: _np_batch(rs, pair["cfg_j"], 2, 9, 4, A=2) for n in ("ga", "gb")}
    optim = dict(OPTIM, freeze_params=("embed_tokens",))
    return _run_steps(pair, nb, dict(label_smoothing=0.1), optim)


@pytest.mark.parametrize("variant", ["accum2", "freeze_embed"])
def test_step_variants_match_jax(pair, variant_step, variant):
    st_j, m_j, st_t, m_t, before = variant_step
    if variant == "accum2":
        assert st_t.step == UPDATE + 1 and st_t.opt_state["count"] == 1
        assert _check_update(pair, *variant_step, OPTIM["lr"]) > 100
        return
    # frozen: no move, no contribution to the clip norm, no Adam moments, on both sides
    i = [path for path, _ in named_leaves(st_t.params)].index("embed_tokens")
    assert torch.equal(st_t.params["embed_tokens"].detach(), before[i])
    np.testing.assert_array_equal(np.asarray(st_j.params["embed_tokens"]),
                                  pair["params_np"]["embed_tokens"])
    assert not st_t.opt_state["mu"]["embed_tokens"].any()
    assert not np.asarray(_adam_state(st_j).mu["embed_tokens"]).any()


def test_nonfinite_gradients_skip_the_update(pair):
    rs = np.random.RandomState(5)
    nb = {"t": _np_batch(rs, pair["cfg_j"], 2, 9, 4)}
    nb["t"]["conf"] = np.full((1, 2), np.nan, np.float32)  # NaN weight → NaN loss
    params_t = _params_t(pair)
    before = [p.detach().clone() for _, p in named_leaves(params_t)]
    state = init_train_state(params_t, tc.OptimConfig(**OPTIM), ema_decay=0.9)
    step = make_train_step(pair["cfg_t"], tc.CriterionConfig(), tc.OptimConfig(**OPTIM),
                           ema_decay=0.9)
    state2, m = step(state, _torch_batches(nb))
    assert float(m["skipped_nonfinite"]) == 1.0 and not np.isfinite(float(m["gnorm"]))
    assert state2.step == 0 and state2.opt_state["count"] == 0
    for (_, p), p0 in zip(named_leaves(state2.params), before):
        assert torch.equal(p.detach(), p0)
    assert not any(m.any() for _, m in named_leaves(state2.opt_state["mu"]))
    assert all(p.grad is None for _, p in named_leaves(state2.params))


# ---------------------------------------------------------------------------
# criterion, schedule, transport, dropout
# ---------------------------------------------------------------------------

CE_OPTIONS = {
    "plain": {},
    "constraint_masks": dict(cm=True),
    "constraint_range": dict(constraint_range=(10, 50)),
    "conf": dict(conf=True),
    "drop_worst": dict(drop_worst_ratio=0.3),
    "drop_worst_inactive": dict(drop_worst_ratio=0.3, drop_worst_active=False),
    "drop_worst_rdrop": dict(drop_worst_ratio=0.3, use_rdrop=True),
    "drop_best": dict(drop_worst_ratio=0.2, drop_best_ratio=0.25),
    "encouraging": dict(encouraging_log_end=0.75),
    "encouraging_log_end_1": dict(encouraging_log_end=1.0, drop_best_ratio=0.2),
    "rdrop_range_conf": dict(use_rdrop=True, constraint_range=(10, 50), conf=True),
}


@pytest.mark.parametrize("option", list(CE_OPTIONS))
def test_label_smoothed_ce_matches_jax(option):
    rs = np.random.RandomState(2)
    B, T, V, Vr = 4, 6, 320, 300
    logits = (rs.randn(B, T, V) * 3).astype(np.float32)
    logits[..., Vr:] = -1e9
    tgt = rs.randint(4, Vr, (B, T)).astype(np.int32)
    tgt[1, -2:] = 1
    kw = dict(CE_OPTIONS[option])
    if kw.get("use_rdrop"):
        logits[B // 2:] = logits[:B // 2] + rs.randn(B // 2, T, V).astype(np.float32) * 0.1
        tgt[B // 2:] = tgt[:B // 2]
    extra_j, extra_t = {}, {}
    if kw.pop("cm", False):
        cm = rs.rand(B, T, V) < 0.2
        cm[..., Vr:] = False
        cm[np.arange(B)[:, None], np.arange(T)[None], tgt] = True
        extra_j["constraint_masks"], extra_t["constraint_masks"] = jnp.asarray(cm), torch.from_numpy(cm)
    if kw.pop("conf", False):
        conf = rs.uniform(0.5, 2.0, B).astype(np.float32)
        extra_j["conf"], extra_t["conf"] = jnp.asarray(conf), torch.from_numpy(conf)
    if "drop_worst_active" in kw:
        extra_j["drop_worst_active"] = jnp.asarray(kw["drop_worst_active"])
    ref = jax_ce(jnp.asarray(logits), jnp.asarray(tgt), 0.1, vocab_size=Vr,
                 **{k: v for k, v in kw.items() if k != "drop_worst_active"}, **extra_j)
    out = label_smoothed_ce(torch.from_numpy(logits), torch.from_numpy(tgt).long(), 0.1,
                            vocab_size=Vr, **kw, **extra_t)
    for name, a, b in zip(("loss", "nll_loss", "ntokens"), out, ref):
        assert _rel(a, b) <= 1e-5, f"{option} {name}: {float(a)} vs {float(b)}"


@pytest.mark.parametrize("optim", [
    dict(lr=1e-4, warmup_updates=10, total_updates=50),
    dict(lr=3e-4, warmup_updates=0, total_updates=40, end_lr=1e-5),
    dict(lr=1e-3, warmup_updates=5, total_updates=30, power=2.0, end_lr=2e-5),
])
def test_lr_schedule_matches_optax(optim):
    ours = polynomial_decay_schedule(tc.OptimConfig(**optim))
    theirs = jax_schedule(jc.OptimConfig(**optim))
    for count in range(0, optim["total_updates"] + 5):
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=2e-6, atol=1e-12)
    assert ours(0) == (0.0 if optim["warmup_updates"] else optim["lr"])


def test_dequantize_batch_matches_jax():
    rs = np.random.RandomState(4)
    imgs = rs.randint(0, 256, (1, 2, 8, 8, 3)).astype(np.uint8)
    norm = np.stack([rs.uniform(0.01, 0.02, (1, 3)), rs.uniform(-2, -1, (1, 3))], 1)
    norm = norm.astype(np.float32)  # [A, 2, 3]
    masks = rs.rand(1, 2, 3, 64) < 0.3
    packed = np.packbits(masks, axis=-1, bitorder="little")
    base = dict(src_tokens=np.zeros((1, 2, 3), np.int32), prev_output_tokens=np.zeros((1, 2, 3), np.int32),
                target=np.zeros((1, 2, 3), np.int32))
    ref = jax_dequantize(JaxTaskBatch(**{k: jnp.asarray(v) for k, v in base.items()},
                                      patch_images=jnp.asarray(imgs), patch_norm=jnp.asarray(norm),
                                      constraint_masks=jnp.asarray(packed)), jnp.float32)
    out = dequantize_batch(TaskBatch(**{k: torch.from_numpy(v) for k, v in base.items()},
                                     patch_images=torch.from_numpy(imgs),
                                     patch_norm=torch.from_numpy(norm),
                                     constraint_masks=torch.from_numpy(packed)), torch.float32)
    assert out.patch_norm is None and out.constraint_masks.dtype == torch.bool
    np.testing.assert_array_equal(out.constraint_masks.numpy(), masks)
    np.testing.assert_array_equal(out.constraint_masks.numpy(), np.asarray(ref.constraint_masks))
    np.testing.assert_allclose(out.patch_images.numpy(), np.asarray(ref.patch_images), rtol=1e-6)


def test_dropout_and_drop_path_behave_as_jax():
    """Different generators give different masks, so compare behaviour: the
    share of zeros, the scale of what is kept, per-sample drop-path, and
    determinism under a seed."""
    n, rate = 200_000, 0.3
    x = torch.ones(n)
    y = ofa._dropout(x, rate, torch.Generator().manual_seed(0), deterministic=False)
    yj = np.asarray(jofa._dropout(jnp.ones(n), rate, jax.random.PRNGKey(0), False))
    sigma = np.sqrt(rate * (1 - rate) / n)
    for out in (y.numpy(), yj):
        assert abs((out == 0).mean() - rate) < 5 * sigma
        np.testing.assert_allclose(out[out != 0], 1 / (1 - rate), rtol=1e-6)
    assert torch.equal(y, ofa._dropout(x, rate, torch.Generator().manual_seed(0), False))
    assert ofa._dropout(x, rate, torch.Generator(), deterministic=True) is x
    assert ofa._dropout(x, rate, None, deterministic=False) is x

    rows, rate = 20_000, 0.25
    x = torch.ones(rows, 3, 4)
    y = ofa._drop_path(x, rate, torch.Generator().manual_seed(1), deterministic=False)
    yj = np.asarray(jofa._drop_path(jnp.ones((rows, 3, 4)), rate, jax.random.PRNGKey(1), False))
    sigma = np.sqrt(rate * (1 - rate) / rows)
    for out in (y.numpy(), yj):
        per_row = out.reshape(rows, -1)
        assert ((per_row == 0).all(1) | (per_row == per_row[:, :1]).all(1)).all()
        assert abs((per_row[:, 0] == 0).mean() - rate) < 5 * sigma
        np.testing.assert_allclose(per_row[per_row != 0], 1 / (1 - rate), rtol=1e-6)
    assert ofa._drop_path(x, None, torch.Generator(), deterministic=False) is x


def test_training_forward_with_dropout_is_seeded(pair):
    cfg = dataclasses.replace(pair["cfg_t"], dropout=0.1, activation_dropout=0.1,
                              encoder_drop_path_rate=0.2, decoder_drop_path_rate=0.2)
    b = {k: torch.from_numpy(v[0]) for k, v in pair["nb"]["gigaword"].items()}
    params = _params_t(pair)

    def run(seed, deterministic=False):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return ofa.forward(params, cfg, b["src_tokens"].long(), b["prev_output_tokens"].long(),
                           generator=g, deterministic=deterministic).detach()

    a, a2, c, det = run(0), run(0), run(1), run(0, deterministic=True)
    assert torch.equal(a, a2)
    assert not torch.equal(a, c) and not torch.equal(a, det)
    assert torch.equal(det, run(None))  # no generator: no dropout
    # attention dropout takes the XLA branch (the JAX gate), seeded as well
    cfg = dataclasses.replace(cfg, attention_dropout=0.1)
    calls = ofa.xla_attention.calls
    x1, x2 = run(0), run(0)
    assert torch.equal(x1, x2) and not torch.equal(x1, a)
    assert ofa.xla_attention.calls - calls == 2 * (cfg.encoder_layers + 2 * cfg.decoder_layers)

