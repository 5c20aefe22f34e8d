"""The port's NormFormer options (``scale_attn``, ``scale_fc``, ``scale_heads``,
``scale_resids``) against the JAX package, on ``ofa_tiny`` cut to 2 + 2
layers and ResNet (1, 1, 1), in float32.

Both sides get one parameter tree: the JAX init with all four options on,
random rel-pos tables and BN statistics, and every NormFormer leaf drawn away
from the init's ones and zeros (a dropped multiply or LayerNorm would pass on
those), bridged through ``from_jax``. The JAX attention runs its Pallas
kernels in interpret mode, the port's the plain versions. Tolerances: the
done rule's 1e-5 of max|ref| for features, logits, caches and beam scores,
beam tokens exactly; the training step under ``test_torch_port_train.py``'s
bounds (loss 1e-5 relative, every gradient leaf 5e-4 of its largest |g|).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import musketeer_tpu.ops.decode_stack as jax_decode_stack
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
from tests.test_torch_port_train import _err, _np_batch, _rel

OPTIONS = ("scale_attn", "scale_fc", "scale_heads", "scale_resids")
NF_LEAVES = ("c_attn", "w_resid", "attn_ln", "self_attn_ln", "cross_attn_ln", "ffn_layernorm")
IMG = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op PyTorch thread for a module's tests (this file's, and the
    other entry-point files' that import it): the port's CPU ops on ``ofa_tiny``
    are small, and beside the suite's other workers, whose threads share the
    same cores, one thread runs them faster than many."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def perturb_normformer(tree, rng):
    """Draw every NormFormer leaf of a JAX-layout numpy tree away from 1 and 0."""
    def walk(node, name=""):
        if not isinstance(node, dict):
            return
        for k, v in node.items():
            if k in ("c_attn", "w_resid"):
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in NF_LEAVES:
                v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
                v["bias"] = (rng.randn(*v["bias"].shape) * 0.1).astype(np.float32)
            else:
                walk(v, k)
    walk(tree)
    return tree


def normformer_cfgs(**kw):
    cfg_j = dataclasses.replace(jc.ofa_tiny(), dtype="float32", use_flash_attention=True,
                                encoder_layers=2, decoder_layers=2, resnet_layers=(1, 1, 1),
                                **{o: True for o in OPTIONS}, **kw)
    return cfg_j, tc.ModelConfig(**dataclasses.asdict(cfg_j))


@pytest.fixture(scope="module")
def nf():
    cfg_j, cfg_t = normformer_cfgs()
    params = jax.jit(jofa.init_ofa_params, static_argnums=1)(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(7)
    tree = perturb_normformer(_randomize(jax.tree.map(np.array, params), rng), rng)
    rs = np.random.RandomState(0)
    src = rs.randint(4, 5000, (2, 8)).astype(np.int32)
    src[:, -1] = cfg_j.eos
    src[0, -3:] = [cfg_j.eos, cfg_j.pad, cfg_j.pad]
    imgs = rs.randn(2, IMG, IMG, 3).astype(np.float32)
    masks = np.ones((2,), bool)
    params_j = jax.tree.map(jnp.asarray, tree)
    params_t = from_jax(tree, cfg_t, "cpu", torch.float32)
    enc_j = jax.jit(lambda p, *a: jofa.encode(p, cfg_j, *a))(
        params_j, jnp.asarray(src), jnp.asarray(imgs), jnp.asarray(masks))
    enc_t = ofa.encode(params_t, cfg_t, torch.from_numpy(src).long(), torch.from_numpy(imgs),
                       torch.from_numpy(masks))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, tree=tree, params_j=params_j, params_t=params_t,
                src=src, enc_j=enc_j, enc_t=enc_t)


def test_init_and_bridge_carry_every_normformer_leaf(nf):
    """The port's init makes JAX's NormFormer leaves (shapes) and ``from_jax``
    carries each across (an unconsumed leaf would raise)."""
    tree = init_ofa_params(nf["cfg_t"], torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(tree) == shapes(nf["tree"])
    enc0 = nf["params_t"]["encoder"]["layers"][0]
    dec0 = nf["params_t"]["decoder"]["layers"][0]
    assert {"attn_ln", "ffn_layernorm", "w_resid"} <= set(enc0)
    assert {"self_attn_ln", "cross_attn_ln", "ffn_layernorm", "w_resid"} <= set(dec0)
    assert "c_attn" in enc0["self_attn"] and "c_attn" in dec0["encoder_attn"]
    np.testing.assert_array_equal(dec0["encoder_attn"]["c_attn"].numpy(),
                                  nf["tree"]["decoder"]["layers"]["encoder_attn"]["c_attn"][0])
    bf16 = from_jax(nf["tree"], nf["cfg_t"], "cpu", torch.bfloat16)["encoder"]["layers"][1]
    assert bf16["w_resid"].dtype == bf16["self_attn"]["c_attn"].dtype == torch.bfloat16
    assert bf16["attn_ln"]["scale"].dtype == torch.float32


def test_encoder_features_match_jax(nf):
    assert _rel_err(nf["enc_t"].x.numpy(), nf["enc_j"].x) <= REL_TOL


def test_teacher_forced_logits_match_jax(nf):
    prev = np.random.RandomState(1).randint(4, 5000, (2, 6)).astype(np.int32)
    prev[:, 0] = nf["cfg_j"].bos
    ref = jax.jit(lambda p, e, t: jofa.decode(p, nf["cfg_j"], t, e))(
        nf["params_j"], nf["enc_j"], jnp.asarray(prev))
    out = ofa.decode(nf["params_t"], nf["cfg_t"], torch.from_numpy(prev).long(), nf["enc_t"])
    assert _rel_err(out.numpy(), ref) <= REL_TOL


def test_decode_steps_match_jax(nf):
    """Three incremental steps at beam 3: logits and self caches."""
    K, max_len = 3, 6
    enc_t = ofa.EncoderOut(*(torch.from_numpy(np.array(a)) for a in nf["enc_j"]))
    st_j = jofa.init_decoder_state(nf["params_j"], nf["cfg_j"], nf["enc_j"], max_len, beam_size=K)
    st_t = ofa.init_decoder_state(nf["params_t"], nf["cfg_t"], enc_t, max_len, beam_size=K)
    toks = np.random.RandomState(3).randint(4, nf["cfg_j"].vocab_size, (3, 2 * K))
    for step in range(3):
        lj, st_j = jofa.decode_step(nf["params_j"], nf["cfg_j"], jnp.asarray(toks[step]),
                                    jnp.int32(step), st_j)
        lt, st_t = ofa.decode_step(nf["params_t"], nf["cfg_t"], torch.from_numpy(toks[step]),
                                   step, st_t)
        assert _rel_err(lt.numpy(), lj) <= REL_TOL, f"step {step} logits"
        for name in ("self_k", "self_v"):
            assert _rel_err(st_t.cache[name].numpy(), st_j.cache[name]) <= REL_TOL, name


def test_caption_beam_matches_jax(nf):
    kw = dict(beam_size=5, max_len_b=12, min_len=1, no_repeat_ngram_size=3)
    toks_j, sc_j = jax_beam_search(nf["params_j"], nf["cfg_j"], jc.GenerationConfig(**kw),
                                   nf["enc_j"], max_len=12)
    toks_t, sc_t = beam_search(nf["params_t"], nf["cfg_t"], tc.GenerationConfig(**kw),
                               nf["enc_t"], max_len=12)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    assert _rel_err(sc_t.numpy(), sc_j) <= REL_TOL


def test_training_step_loss_and_gradients_match_jax(nf):
    """The joint loss of a vision task with R-Drop (dropout rates 0 in the
    training branch) and its gradient, every leaf, the NormFormer ones too."""
    rs = np.random.RandomState(3)
    cfg_j = nf["cfg_j"]
    nb = {"caption": _np_batch(rs, cfg_j, 2, 8, 5, img=True)}
    for b in nb.values():  # one microbatch, no accumulation axis
        for k in b:
            b[k] = b[k][0]
    nb["caption"]["patch_images"] = rs.rand(2, IMG, IMG, 3).astype(np.float32)
    crit_j, crit_t = jc.CriterionConfig(use_rdrop=True), tc.CriterionConfig(use_rdrop=True)
    batches_j = {n: JaxTaskBatch(**{k: jnp.asarray(v) for k, v in b.items()}) for n, b in nb.items()}
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_multitask_loss(p, cfg_j, crit_j, b, jax.random.PRNGKey(0),
                                        jnp.int32(0))[0]))
    loss_j, grads_j = grad_fn(nf["params_j"], batches_j)
    params_t = trainable(from_jax(nf["tree"], nf["cfg_t"], "cpu", torch.float32))
    batches_t = {n: TaskBatch(**{k: torch.from_numpy(v).long() if v.dtype == np.int32
                                 else torch.from_numpy(v) for k, v in b.items()})
                 for n, b in nb.items()}
    loss_t, _ = multitask_loss(params_t, nf["cfg_t"], crit_t, batches_t,
                               torch.Generator().manual_seed(0), 0)
    loss_t.backward()
    assert _rel(loss_t, loss_j) <= 1e-5
    gj = named_leaves(from_jax(jax.tree.map(np.asarray, grads_j), nf["cfg_t"], "cpu",
                               torch.float32))
    gt = [(path, p.grad) for path, p in named_leaves(params_t)]
    assert [p for p, _ in gt] == [p for p, _ in gj]
    floor = 1e-4 * max(float(g.abs().max()) for _, g in gj)
    checked = set()
    for (path, g_t), (_, g_j) in zip(gt, gj):
        g_j = g_j.numpy()
        scale = max(float(np.abs(g_j).max()), floor)
        g_t = np.zeros_like(g_j) if g_t is None else g_t.numpy()
        assert _err(g_t, g_j) <= 5e-4 * scale, f"{path}: {_err(g_t, g_j)} vs max |g| {scale}"
        if np.abs(g_j).max() > floor:
            checked.add(path)
    for leaf in ("encoder.layers.self_attn.c_attn", "decoder.layers.encoder_attn.c_attn",
                 "encoder.layers.w_resid", "decoder.layers.w_resid",
                 "encoder.layers.attn_ln.scale", "decoder.layers.self_attn_ln.scale",
                 "decoder.layers.cross_attn_ln.bias", "encoder.layers.ffn_layernorm.scale"):
        assert leaf in checked, leaf


def _stack_calls_jax(params_j, cfg_j, enc_j, K):
    st = jofa.init_decoder_state(params_j, cfg_j, enc_j, 4, beam_size=K)
    rows = enc_j.x.shape[0] * K
    with mock.patch.object(jax_decode_stack, "decode_stack_step",
                           wraps=jax_decode_stack.decode_stack_step) as calls:
        jofa.decode_step(params_j, cfg_j, jnp.full((rows,), cfg_j.bos, jnp.int32),
                         jnp.int32(0), st)
    return calls.call_count


@pytest.mark.parametrize("option", ["none"] + list(OPTIONS))
def test_stack_routing_matches_jax(nf, option):
    """K7 takes a step of an even sample count only without a NormFormer option,
    on both sides; with one, the step runs layer by layer (and matches JAX)."""
    cfg_j = dataclasses.replace(nf["cfg_j"], decode_stack_kernel=True,
                                **{o: o == option for o in OPTIONS})
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    tree = init_ofa_params(cfg_t, torch.Generator().manual_seed(1), "cpu")
    tree = jax.tree.map(lambda t: t.numpy(), tree)
    params_j = jax.tree.map(jnp.asarray, tree)
    params_t = from_jax(tree, cfg_t, "cpu", torch.float32)
    K = 2
    enc_t = ofa.EncoderOut(*(torch.from_numpy(np.array(a)) for a in nf["enc_j"]))
    st_t = ofa.init_decoder_state(params_t, cfg_t, enc_t, 4, beam_size=K)
    assert (st_t.kernel_pack is None) == (option != "none")
    rows = enc_t.x.shape[0] * K
    with mock.patch.object(ofa, "decode_stack_step", wraps=ofa.decode_stack_step) as calls:
        lt, _ = ofa.decode_step(params_t, cfg_t, torch.full((rows,), cfg_t.bos), 0, st_t)
    expected = int(option == "none")
    assert calls.call_count == expected
    assert _stack_calls_jax(params_j, cfg_j, nf["enc_j"], K) == expected
    st_j = jofa.init_decoder_state(params_j, cfg_j, nf["enc_j"], 4, beam_size=K)
    lj, _ = jofa.decode_step(params_j, cfg_j, jnp.full((rows,), cfg_j.bos, jnp.int32),
                             jnp.int32(0), st_j)
    assert _rel_err(lt.numpy(), lj) <= REL_TOL


def test_stack_route_refuses_a_normformer_tree_under_a_plain_config(nf):
    """A tree with NormFormer leaves under a config that names no option (a
    training checkpoint read under its preset): no K7 pack, the per-layer
    step, which applies the leaves."""
    cfg = dataclasses.replace(nf["cfg_t"], decode_stack_kernel=True,
                              **{o: False for o in OPTIONS})
    st = ofa.init_decoder_state(nf["params_t"], cfg, nf["enc_t"], 4, beam_size=2)
    assert st.kernel_pack is None
