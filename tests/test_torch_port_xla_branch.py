"""The port's XLA attention branch and the options it carries against the JAX
package, on ``ofa_tiny`` cut to 2 + 2 layers and ResNet (1, 1, 1), in float32.

One JAX parameter tree carries every optional leaf (adapters, encoder and
decoder prompts, the NormFormer leaves), with random rel-pos tables and BN
statistics and the optional leaves drawn away from their init; each case
strips the leaves its config does not turn on and bridges the rest through
``from_jax``. The JAX model runs with ``use_flash_attention=False`` (its XLA
branch) unless a case names the flash branch, whose Pallas kernels then run
in interpret mode. Tolerances: the done rule's 1e-5 of max|ref| for
features, logits, caches and beam scores, beam tokens exactly; the joint
step's loss within 1e-5 relative and every gradient leaf within 5e-4 of its
largest |g| (``test_torch_port_train.py``'s bounds). Attention dropout's
masks come from different generators, so its keep rate and scale are
compared by statistics.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu import config as jc
from musketeer_tpu.generation import beam_search as jax_beam_search
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.training import TaskBatch as JaxTaskBatch
from musketeer_tpu.training.train_step import multitask_loss as jax_multitask_loss
from musketeer_tpu_torch import config as tc
from musketeer_tpu_torch.generation import beam_search
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.params import from_jax, init_ofa_params, trainable
from musketeer_tpu_torch.training.train_state import named_leaves
from musketeer_tpu_torch.training.train_step import TaskBatch, multitask_loss
from tests.test_torch_port_model import REL_TOL, _randomize, _rel_err
from tests.test_torch_port_normformer import one_thread, perturb_normformer  # noqa: F401
from tests.test_torch_port_train import _err, _rel

NORMFORMER = ("scale_attn", "scale_fc", "scale_heads", "scale_resids")
ALL_OPTIONS = dict(use_adapter=True, encoder_prompt=True, decoder_prompt=True,
                   **dict.fromkeys(NORMFORMER, True))


def cfgs(**kw):
    cfg_j = dataclasses.replace(
        jc.ofa_tiny(), **{**dict(
            dtype="float32", use_flash_attention=False, encoder_layers=2, decoder_layers=2,
            resnet_layers=(1, 1, 1), encoder_prompt_length=5, decoder_prompt_length=4,
            adapter_dim=16, orig_patch_image_size=32), **kw})
    return cfg_j, tc.ModelConfig(**dataclasses.asdict(cfg_j))


def strip(tree, cfg):
    """The full tree without the optional leaves ``cfg`` does not turn on."""
    tree = copy.deepcopy(tree)
    drop = {"adapter"} if not cfg.use_adapter else set()
    if not cfg.scale_attn:
        drop |= {"attn_ln", "self_attn_ln", "cross_attn_ln"}
    if not cfg.scale_fc:
        drop.add("ffn_layernorm")
    if not cfg.scale_resids:
        drop.add("w_resid")
    for side, prompt in (("encoder", cfg.encoder_prompt), ("decoder", cfg.decoder_prompt)):
        if not prompt:
            del tree[side]["prompt_embedding"]
        layers = tree[side]["layers"]
        for name in drop & set(layers):
            del layers[name]
        if not cfg.scale_heads:
            for attn in ("self_attn", "encoder_attn"):
                layers.get(attn, {}).pop("c_attn", None)
    return tree


@pytest.fixture(scope="module")
def full():
    cfg_j, _ = cfgs(**ALL_OPTIONS)
    params = jax.jit(jofa.init_ofa_params, static_argnums=1)(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(7)
    tree = perturb_normformer(_randomize(jax.tree.map(np.array, params), rng), rng)
    for side in ("encoder", "decoder"):  # adapters well away from their near-zero init
        for proj in tree[side]["layers"]["adapter"].values():
            proj["w"] = (rng.randn(*proj["w"].shape) * 0.2).astype(np.float32)
            proj["b"] = (rng.randn(*proj["b"].shape) * 0.1).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def model(full):
    """``model(**options)`` → (cfg_j, cfg_t, params_j, params_t, tree), built once per options."""
    cache = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cfg_j, cfg_t = cfgs(**kw)
            tree = strip(full, cfg_j)
            cache[key] = (cfg_j, cfg_t, jax.tree.map(jnp.asarray, tree),
                          from_jax(tree, cfg_t, "cpu", torch.float32), tree)
        return cache[key]
    return get


def _inputs(img=32, B=2, seed=0):
    rs = np.random.RandomState(seed)
    src = rs.randint(4, 5000, (B, 8)).astype(np.int32)
    src[:, -1] = 2
    src[0, -3:] = [2, 1, 1]  # a padded row
    imgs = rs.randn(B, img, img, 3).astype(np.float32)
    masks = np.array([True, False] + [True] * (B - 2))  # one row without its image
    return src, imgs, masks


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)


def _enc_t(enc_j):
    return ofa.EncoderOut(*(torch.from_numpy(np.array(a)) for a in enc_j))


def _assert_enc(out, ref):
    assert _rel_err(out.x.numpy(), ref.x) <= REL_TOL
    np.testing.assert_array_equal(out.padding_mask.numpy(), np.asarray(ref.padding_mask))
    assert _rel_err(out.pos_embed.numpy(), ref.pos_embed) <= REL_TOL


ENCODE_CASES = {
    "plain": ({}, {}, 32),
    "sample_patch_order": ({}, {"order": 10}, 64),
    "interpolate_position": (dict(interpolate_position=True), {}, 48),
    "encoder_prompt": (dict(encoder_prompt=True), {}, 32),
    "adapter": (dict(use_adapter=True), {}, 32),
    "normformer": (dict.fromkeys(NORMFORMER, True), {}, 32),
    "train_bn": ({}, {"train_bn": True}, 32),
    "text_only": ({}, {"text_only": True}, 32),
}


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_matches_jax(model, case):
    options, call, img = ENCODE_CASES[case]
    cfg_j, cfg_t, params_j, params_t, _ = model(**options)
    src, imgs, masks = _inputs(img)
    kw_j, kw_t = {}, {}
    if "order" in call:
        n = (img // 16) ** 2
        rs = np.random.RandomState(1)
        order = np.stack([rs.permutation(n)[:call["order"]] for _ in range(2)]).astype(np.int32)
        kw_j["sample_patch_order"], kw_t["sample_patch_order"] = jnp.asarray(order), _t(order)
    if call.get("train_bn"):
        kw_j["train_bn"] = kw_t["train_bn"] = True
    if call.get("text_only"):
        imgs = masks = None
    calls = ofa.xla_attention.calls
    ref = jofa.encode(params_j, cfg_j, jnp.asarray(src), None if imgs is None else jnp.asarray(imgs),
                      None if masks is None else jnp.asarray(masks), **kw_j)
    out = ofa.encode(params_t, cfg_t, _t(src), None if imgs is None else _t(imgs),
                     None if masks is None else _t(masks), **kw_t)
    _assert_enc(out, ref)
    assert ofa.xla_attention.calls - calls == cfg_t.encoder_layers
    if "order" in call:
        assert out.x.shape[1] == call["order"] + src.shape[1]


@pytest.fixture(scope="module")
def enc_j(model):
    cfg_j, _, params_j, _, _ = model()
    src, imgs, masks = _inputs()
    return jofa.encode(params_j, cfg_j, jnp.asarray(src), jnp.asarray(imgs), jnp.asarray(masks))


def _prev(T=6, B=2, seed=1):
    prev = np.random.RandomState(seed).randint(4, 5000, (B, T)).astype(np.int32)
    prev[:, 0] = 0
    prev[1, -1] = 1  # a padded target position
    return prev


DECODE_CASES = {
    "no_code_masks": ({}, None, False),
    "mixed_code_masks": ({}, [True, False], False),
    "all_code_masks": ({}, [True, True], False),
    # the static all-code promise keeps the flash branch (Pallas in interpret mode)
    "code_masks_all_flash": (dict(use_flash_attention=True), [True, True], True),
    "decoder_prompt": (dict(decoder_prompt=True), None, False),
    # the JAX model seeds no prompts into a batch with code masks
    "decoder_prompt_mixed_code_masks": (dict(decoder_prompt=True), [False, True], False),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_teacher_forced_decode_matches_jax(model, enc_j, case):
    options, cm, cm_all = DECODE_CASES[case]
    cfg_j, cfg_t, params_j, params_t, _ = model(**options)
    prev = _prev()
    cm_j = None if cm is None else jnp.asarray(cm)
    cm_t = None if cm is None else torch.tensor(cm)
    calls = ofa.xla_attention.calls
    ref = jofa.decode(params_j, cfg_j, jnp.asarray(prev), enc_j, code_masks=cm_j,
                      code_masks_all=cm_all)
    out = ofa.decode(params_t, cfg_t, _t(prev), _enc_t(enc_j), code_masks=cm_t,
                     code_masks_all=cm_all)
    assert _rel_err(out.numpy(), ref) <= REL_TOL
    expect = 0 if cfg_t.use_flash_attention else 2 * cfg_t.decoder_layers
    assert ofa.xla_attention.calls - calls == expect


INCREMENTAL_CASES = {
    "decoder_prompt": (dict(decoder_prompt=True), None),
    "code_masks": ({}, [True] * 3 + [False] * 3),
    "decoder_prompt_and_code_masks": (dict(decoder_prompt=True), [False] * 3 + [True] * 3),
}


@pytest.mark.parametrize("case", list(INCREMENTAL_CASES))
def test_decode_steps_match_jax(model, enc_j, case):
    """Three incremental steps at beam 3: logits and self caches (prompt slots too)."""
    options, cm = INCREMENTAL_CASES[case]
    cfg_j, cfg_t, params_j, params_t, _ = model(**options)
    K, max_len = 3, 6
    cm_j = None if cm is None else jnp.asarray(cm)
    cm_t = None if cm is None else torch.tensor(cm)
    st_j = jofa.init_decoder_state(params_j, cfg_j, enc_j, max_len, code_masks=cm_j, beam_size=K)
    st_t = ofa.init_decoder_state(params_t, cfg_t, _enc_t(enc_j), max_len, code_masks=cm_t,
                                  beam_size=K)
    P = cfg_t.decoder_prompt_length if cfg_t.decoder_prompt else 0
    assert st_t.cache["self_k"].shape[3] == P + max_len
    toks = np.random.RandomState(3).randint(4, cfg_j.vocab_size, (3, 2 * K))
    for step in range(3):
        lj, st_j = jofa.decode_step(params_j, cfg_j, jnp.asarray(toks[step]), jnp.int32(step),
                                    st_j, code_masks=cm_j)
        lt, st_t = ofa.decode_step(params_t, cfg_t, torch.from_numpy(toks[step]), step, st_t,
                                   code_masks=cm_t)
        assert _rel_err(lt.numpy(), lj) <= REL_TOL, f"step {step} logits"
        for name in ("self_k", "self_v"):
            assert _rel_err(st_t.cache[name].numpy(), st_j.cache[name]) <= REL_TOL, name


def test_caption_beam_with_decoder_prompt_matches_jax(model, enc_j):
    cfg_j, cfg_t, params_j, params_t, _ = model(decoder_prompt=True)
    kw = dict(beam_size=5, max_len_b=10, min_len=1, no_repeat_ngram_size=3)
    toks_j, sc_j = jax_beam_search(params_j, cfg_j, jc.GenerationConfig(**kw), enc_j, max_len=10)
    toks_t, sc_t = beam_search(params_t, dataclasses.replace(cfg_t, decode_stack_kernel=True),
                               tc.GenerationConfig(**kw), _enc_t(enc_j), max_len=10)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    assert _rel_err(sc_t.numpy(), sc_j) <= REL_TOL
    # no K7 pack with decoder prompts, as the JAX gate has it
    st = ofa.init_decoder_state(params_t, dataclasses.replace(cfg_t, decode_stack_kernel=True),
                                _enc_t(enc_j), 4)
    assert st.kernel_pack is None


def test_init_and_bridge_carry_every_optional_leaf(full, model):
    """The port's init makes JAX's adapter and prompt leaves (shapes), and
    ``from_jax`` consumes each of them once."""
    cfg_j, cfg_t, _, params_t, _ = model(**ALL_OPTIONS)
    tree = init_ofa_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(tree) == shapes(full)
    lp = params_t["decoder"]["layers"][1]
    np.testing.assert_array_equal(lp["adapter"]["up_proj"]["w"].numpy(),
                                  full["decoder"]["layers"]["adapter"]["up_proj"]["w"][1].T)
    np.testing.assert_array_equal(params_t["encoder"]["prompt_embedding"].numpy(),
                                  full["encoder"]["prompt_embedding"])
    bf16 = from_jax(strip(full, cfg_j), cfg_t, "cpu", torch.bfloat16)
    assert bf16["decoder"]["prompt_embedding"].dtype == torch.bfloat16
    assert bf16["encoder"]["layers"][0]["adapter"]["down_proj"]["w"].dtype == torch.bfloat16
    assert bf16["encoder"]["pos_q_linear"]["w"].dtype == torch.float32
    assert bf16["encoder"]["image_rel_pos_table"].dtype == torch.float32


def test_joint_step_gradients_match_jax(model):
    """The reference's joint recipe in small: a caption batch subsampled to 8
    of its 16 patches (its encoder on the XLA branch) beside a pure-image
    batch of code targets (``code_masks_all``: its decoder on the flash
    branch) under ``use_flash_attention=True``; the loss and every gradient leaf."""
    cfg_j, cfg_t, params_j, _, tree = model(use_flash_attention=True)
    rs = np.random.RandomState(3)

    def batch(T, code):
        tgt = rs.randint(4, 1000, (2, T)).astype(np.int32)
        tgt[:, -1] = cfg_j.eos
        tgt[0, -2:] = cfg_j.pad
        prev = np.roll(tgt, 1, 1)
        prev[:, 0] = cfg_j.bos
        src = rs.randint(4, 1000, (2, 7)).astype(np.int32)
        src[-1, -2:] = cfg_j.pad
        b = dict(src_tokens=src, prev_output_tokens=prev, target=tgt,
                 patch_images=rs.rand(2, 64, 64, 3).astype(np.float32),
                 patch_masks=np.ones(2, bool))
        if code:
            b["code_masks"] = np.ones(2, bool)
            b["conf"] = np.full(2, 2.0, np.float32)
        else:
            b["sample_patch_order"] = np.stack([rs.permutation(16)[:8] for _ in range(2)]).astype(np.int32)
        return b

    nb = {"caption": batch(5, False), "pure_image": batch(9, True)}
    crit_j, crit_t = jc.CriterionConfig(), tc.CriterionConfig()
    batches_j = {n: JaxTaskBatch(**{k: jnp.asarray(v) for k, v in b.items()}) for n, b in nb.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jax_multitask_loss(p, cfg_j, crit_j, b, None, jnp.int32(0))[0]))(
            params_j, batches_j)
    params_t = trainable(from_jax(tree, cfg_t, "cpu", torch.float32))
    batches_t = {n: TaskBatch(**{k: _t(v) for k, v in b.items()}) for n, b in nb.items()}
    calls = ofa.xla_attention.calls
    loss_t, _ = multitask_loss(params_t, cfg_t, crit_t, batches_t, None, 0)
    assert ofa.xla_attention.calls - calls == cfg_t.encoder_layers  # the caption encoder only
    loss_t.backward()
    assert _rel(loss_t, loss_j) <= 1e-5
    gj = named_leaves(from_jax(jax.tree.map(np.asarray, grads_j), cfg_t, "cpu", torch.float32))
    gt = [(path, p.grad) for path, p in named_leaves(params_t)]
    assert [p for p, _ in gt] == [p for p, _ in gj]
    floor = 1e-4 * max(float(g.abs().max()) for _, g in gj)
    for (path, g_t), (_, g_j) in zip(gt, gj):
        g_j = g_j.numpy()
        scale = max(float(np.abs(g_j).max()), floor)
        g_t = np.zeros_like(g_j) if g_t is None else g_t.numpy()
        assert _err(g_t, g_j) <= 5e-4 * scale, f"{path}: {_err(g_t, g_j)} vs max |g| {scale}"


def test_attention_dropout_behaves_as_jax():
    """One head whose queries and keys project to zero (uniform probabilities)
    and whose values and output are identities, so each branch's output is
    its dropped-out probability matrix: the share of zeros is the rate and
    what is kept is 1/Tk scaled by 1/(1 − rate), on both packages; a seed
    repeats its masks."""
    n, rate = 128, 0.3
    cfg_j = dataclasses.replace(jc.ofa_tiny(), dtype="float32", embed_dim=n, attention_heads=1,
                                attention_dropout=rate)
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    eye, zero = np.eye(n, dtype=np.float32), np.zeros((n, n), np.float32)
    lin = lambda w: {"w": w, "b": np.zeros(n, np.float32)}
    p_np = {"q_proj": lin(zero), "k_proj": lin(zero), "v_proj": lin(eye), "out_proj": lin(eye)}
    x = eye[None]
    out_j = np.asarray(jofa.attention(jax.tree.map(jnp.asarray, p_np), cfg_j, x, x, x, None, None,
                                      rng=jax.random.PRNGKey(0), deterministic=False,
                                      dropout_rate=rate))[0]
    p_t = {k: {"w": torch.from_numpy(v["w"].T.copy()), "b": torch.from_numpy(v["b"])}
           for k, v in p_np.items()}
    run = lambda seed: ofa.xla_attention(p_t, cfg_t, torch.from_numpy(x), torch.from_numpy(x),
                                         None, None, gen=torch.Generator().manual_seed(seed),
                                         deterministic=False)[0].numpy()
    out_t = run(0)
    sigma = np.sqrt(rate * (1 - rate) / n ** 2)
    for out in (out_t, out_j):
        assert abs((out == 0).mean() - rate) < 5 * sigma
        np.testing.assert_allclose(out[out != 0], 1 / n / (1 - rate), rtol=1e-5)
    np.testing.assert_array_equal(out_t, run(0))
    assert not np.array_equal(out_t, run(1))
    det = ofa.xla_attention(p_t, cfg_t, torch.from_numpy(x), torch.from_numpy(x), None, None)
    np.testing.assert_allclose(det[0].numpy(), np.full((n, n), 1 / n), rtol=1e-6)


def test_attention_dropout_deterministic_runs_match_jax(model):
    """With ``attention_dropout`` set, a deterministic forward equals JAX's on
    either branch, and a training forward takes the XLA branch (the JAX gate)."""
    for flash in (False, True):
        cfg_j, cfg_t, params_j, params_t, _ = model(use_flash_attention=flash)
        cfg_j = dataclasses.replace(cfg_j, attention_dropout=0.1)
        cfg_t = dataclasses.replace(cfg_t, attention_dropout=0.1)
        src, imgs, masks = _inputs()
        prev = _prev()
        ref = jofa.forward(params_j, cfg_j, jnp.asarray(src), jnp.asarray(prev),
                           jnp.asarray(imgs), jnp.asarray(masks))
        calls = ofa.xla_attention.calls
        out = ofa.forward(params_t, cfg_t, _t(src), _t(prev), _t(imgs), _t(masks))
        assert _rel_err(out.numpy(), ref) <= REL_TOL
        layers = cfg_t.encoder_layers + 2 * cfg_t.decoder_layers
        assert ofa.xla_attention.calls - calls == (0 if flash else layers)
    calls = ofa.xla_attention.calls
    train = ofa.forward(params_t, cfg_t, _t(src), _t(prev), _t(imgs), _t(masks),
                        generator=torch.Generator().manual_seed(0), deterministic=False)
    assert ofa.xla_attention.calls - calls == layers
    assert not torch.equal(train, out)


def test_port_branches_agree(model):
    """The port's flash and XLA branches on an input both JAX branches accept."""
    _, cfg_x, _, params_t, _ = model()
    cfg_f = dataclasses.replace(cfg_x, use_flash_attention=True)
    src, imgs, masks = _inputs()
    prev = _prev()
    xla = ofa.forward(params_t, cfg_x, _t(src), _t(prev), _t(imgs), _t(masks))
    flash = ofa.forward(params_t, cfg_f, _t(src), _t(prev), _t(imgs), _t(masks))
    assert _rel_err(flash.numpy(), xla.numpy()) <= REL_TOL
