"""The port at every head dim up to 128 against the JAX package, on the CPU.

The attention kernels (K1, K3, K4, K5, K6, K7) are compiled at the tile widths
``_build.HEAD_DIMS`` (32, 64, 80, 128); a head dim D of 1 to 128 runs on the
smallest that covers it, the tiles' columns past D zeros (TMA fills them, or
the loads skip them), and a D that is not a multiple of 8 (K6: of 16) runs on
zero-padded copies of the streams. The kernels run only on the card; here, on
the same seeded numpy inputs:

- (i) the tile walks of K1 and K3/K4 (``test_torch_port_attention_walk.py``,
  ``test_torch_port_attention_bwd_walk.py``) at D 16, 32 and 128, on the
  streams zero-filled to the instance's width as the kernels' tiles are,
  against the Pallas kernels in interpret mode, in bf16, to chip_smoke.py's
  tolerance (2⁻⁶ of max(1, max|ref|));
- (ii) the K6 and K7 walks at hd 32 and 128 against the JAX kernels;
- (iii) ``ofa_tiny`` widened to hd 128 (d 256, 2 heads; 2 + 2 layers, ResNet
  (1, 1, 1), 64² images) and the JAX package's own hd 16 model
  (``tests/test_model.py::tiny_cfg``: d 64, 4 heads), float32, the JAX tree
  bridged by ``from_jax``: encode and beam search against the JAX flash
  branch (tokens exactly, encoder features and beam scores within 1e-5 of
  max|ref|), two serving-B decode steps, and the joint step's loss and
  gradients to the bounds of ``test_torch_port_head_dim.py``;
- (iv) with no card: the zero-padded copy (pad, run the plain version, slice)
  against the plain version at D 20, and the instance map and the
  shared-memory planners at every instance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from musketeer_tpu import config as jc
from musketeer_tpu.config import GenerationConfig as JaxGenerationConfig
from musketeer_tpu.generation import beam_search as jax_beam_search
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.ops.decode_cross_attn import decode_cross_attention_int8 as jax_k6
from musketeer_tpu.ops.decode_stack import decode_stack_step as jax_k7
from musketeer_tpu.ops.decode_stack import pack_decoder_weights as jax_pack
from musketeer_tpu.ops.decode_stack import transpose_cross_kv
from musketeer_tpu.ops.flash_attention_bwd import _bwd as jax_bwd
from musketeer_tpu.ops.flash_attention_bwd import _fwd as jax_fwd
from musketeer_tpu.ops.flash_attention_infer import flash_attention_inference as jax_k1
from musketeer_tpu.training.train_step import multitask_loss as jax_multitask_loss
from musketeer_tpu_torch import config as tc
from musketeer_tpu_torch.config import GenerationConfig
from musketeer_tpu_torch.generation import beam_search
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.ops import _build
from musketeer_tpu_torch.ops import decode_cross_attn as k6
from musketeer_tpu_torch.ops import decode_stack as k7
from musketeer_tpu_torch.ops import flash_attention as k5
from musketeer_tpu_torch.ops import flash_attention_bwd as kb
from musketeer_tpu_torch.ops import flash_attention_infer as k1
from musketeer_tpu_torch.params import from_jax, init_ofa_params, trainable
from musketeer_tpu_torch.training.train_state import global_norm, named_leaves
from musketeer_tpu_torch.training.train_step import multitask_loss
from tests.test_model import make_batch, tiny_cfg
from tests.test_torch_port_attention_bwd_walk import GRADS, walk_bwd
from tests.test_torch_port_attention_walk import TOL, walk
from tests.test_torch_port_decode_walk import walk_stack
from tests.test_torch_port_int8_decode_walk import walk_k6
from tests.test_torch_port_model import REL_TOL, _randomize, _rel_err
from tests.test_torch_port_normformer import one_thread  # noqa: F401  (fixture)
from tests.test_torch_port_serving_kernels import K6_NAMES, _k6_inputs
from tests.test_torch_port_train import _err, _jax_batches, _micro, _np_batch, _rel, _torch_batches
from tests.test_torch_port_train_kernels import _inputs, _jax_args, _torch_args

# (i): one case a head dim: rel with padded keys over ragged tiles, or causal
WALKS = {16: dict(T=70, S=70), 32: dict(T=40, S=40, causal=True), 128: dict(T=70, S=70)}


def _walk_inputs(D: int) -> dict:
    """WALKS[D]'s inputs; causal, the first key unpadded, so that no query
    row is fully masked (the JAX training kernel spreads such a row over its
    padded keys: ``test_torch_port_train_kernels.py`` keeps those cases)."""
    x = _inputs(D=D, **WALKS[D])
    if WALKS[D].get("causal"):
        x["kpad"][:, 0] = False
    return x


def _bf16_err(out: torch.Tensor, ref) -> tuple:
    ref = np.asarray(ref, np.float32)
    assert tuple(out.shape) == ref.shape
    err = float(np.abs(out.float().numpy() - ref).max())
    return err, TOL * max(1.0, float(np.abs(ref).max()))


def _tile(t, D: int):
    """A stream as the kernel's tiles hold it: zeros past D to its instance's width."""
    if t is None or t.dim() != 4:
        return t
    return F.pad(t, (0, _build.head_instance(D) - D))


@pytest.mark.parametrize("D", list(WALKS))
def test_k1_walk_at_any_head_dim_matches_jax_kernel(D):
    x, causal = _walk_inputs(D), WALKS[D].get("causal", False)
    ref = jax_k1(*_jax_args(x, jnp.bfloat16), causal=causal)
    out = walk(*(_tile(t, D) for t in _torch_args(x, torch.bfloat16)), causal=causal)
    err, lim = _bf16_err(out[..., :D], ref)
    assert out.dtype == torch.bfloat16 and err <= lim, f"D{D}: {err} > {lim}"


@pytest.mark.parametrize("D", list(WALKS))
def test_k3_k4_walks_at_any_head_dim_match_jax_kernels(D):
    x, causal = _walk_inputs(D), WALKS[D].get("causal", False)
    B, _, T, _ = x["q"].shape
    o_j, res = jax_fwd(*_jax_args(x, jnp.bfloat16), causal, 128, True, want_res=True)
    lse_j = np.array(res[6])[:B, :, :T, 0]
    t = [_tile(a, D) for a in _torch_args(x, torch.bfloat16)]
    o_w, lse_w = walk(*t, causal=causal, want_lse=True)  # K3: K1's walk with its lse
    err, lim = _bf16_err(o_w[..., :D], o_j)
    assert err <= lim, f"D{D} o: {err} > {lim}"
    assert float(np.abs(lse_w.numpy() - lse_j).max()) <= 1e-4 * max(1.0, np.abs(lse_j).max())
    ref = jax_bwd(res, causal, 128, True, True, jnp.asarray(x["do"], jnp.bfloat16))
    o = torch.from_numpy(np.asarray(o_j, np.float32)).to(torch.bfloat16)
    do = torch.from_numpy(x["do"]).to(torch.bfloat16)
    out = walk_bwd(*t, _tile(o, D), torch.from_numpy(lse_j), _tile(do, D), causal=causal)
    for name, a, b in zip(GRADS, out, ref):
        if a.dim() == 4:
            assert not a[..., D:].any(), f"D{D} {name}: the zero columns got a gradient"
            a = a[..., :D]
        err, lim = _bf16_err(a, b)
        assert err <= lim, f"D{D} {name}: {err} > {lim}"


@pytest.mark.parametrize("D", [32, 128])
def test_k6_walk_at_any_head_dim_matches_jax_kernel(D):
    x = _k6_inputs(B=3, H=2, Kb=5, S=150, D=D, full_pad=2, seed=6)
    args = [torch.from_numpy(x["q"]).to(torch.bfloat16)] + \
        [torch.from_numpy(x[n]) for n in K6_NAMES[1:]]
    out = walk_k6(*args)
    ref = np.asarray(jax_k6(jnp.asarray(x["q"], jnp.bfloat16),
                            *(jnp.asarray(x[n]) for n in K6_NAMES[1:])).astype(jnp.float32))
    live = [b for b in range(ref.shape[0]) if not x["enc_pad"][b].all()]
    err, lim = _bf16_err(out[live], ref[live])
    assert err <= lim, f"D{D}: {err} > {lim}"
    assert (out[2] == 0).all()  # the fully padded sample (JAX on XLA:CPU gives NaN there)


def _stack_inputs(hd: int):
    """A 2-layer stack at head dim hd, 2 heads (d 2 hd, f 2 d), rows 6 = 2
    samples x 3 beams."""
    L, B, Kb, H, Tmax, S = 2, 2, 3, 2, 6, 24
    d, rows = H * hd, B * Kb
    f = 2 * d
    rng = np.random.RandomState(hd)
    w = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)
    lin = lambda din, dout: {"w": w(L, din, dout), "b": w(L, dout)}
    ln = lambda: {"scale": (1 + rng.randn(L, d) * 0.1).astype(np.float32), "bias": w(L, d)}
    attn = lambda: {n: lin(d, d) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    layers = {"self_attn": attn(), "encoder_attn": attn(), "fc1": lin(d, f), "fc2": lin(f, d),
              "self_attn_layer_norm": ln(), "encoder_attn_layer_norm": ln(),
              "final_layer_norm": ln()}
    cbias = rng.randn(B, H, S).astype(np.float32)
    cbias[0, :, -5:] = k7.NEG_INF
    x = dict(x0=rng.randn(rows, d), sbias=rng.randn(L, rows, H, Tmax), cbias=cbias,
             self_k=rng.randn(L, rows, H, Tmax, hd), self_v=rng.randn(L, rows, H, Tmax, hd),
             cross_k=rng.randn(L, B, H, S, hd), cross_v=rng.randn(L, B, H, S, hd))
    x = {n: a.astype(np.float32) for n, a in x.items()}
    port_layers = [jax.tree.map(lambda a: torch.from_numpy(np.ascontiguousarray(
        a[i].T if a.ndim == 3 else a[i])), layers) for i in range(L)]
    return layers, port_layers, x, Kb, float(hd * 2.0) ** -0.5


@pytest.mark.parametrize("hd", [32, 128])
def test_k7_walk_at_any_head_dim_matches_jax_kernel(hd):
    layers, port_layers, x, Kb, scaling = _stack_inputs(hd)
    bf = lambda n: jnp.asarray(x[n], jnp.bfloat16)
    kt, vt = transpose_cross_kv(bf("cross_k"), bf("cross_v"))
    ref = jax_k7(jax_pack(jax.tree.map(jnp.asarray, layers), jnp.bfloat16), bf("x0"),
                 jnp.asarray(x["sbias"]), jnp.asarray(x["cbias"]), bf("self_k"), bf("self_v"),
                 kt, vt, jnp.int32(3), beam_size=Kb, scaling=scaling)
    pack = k7.pack_decoder_weights(port_layers, torch.bfloat16)
    args = [torch.from_numpy(x[n]) for n in ("x0", "sbias", "cbias", "self_k", "self_v",
                                              "cross_k", "cross_v")]
    for i in (0, 3, 4, 5, 6):
        args[i] = args[i].to(torch.bfloat16)
    # d 64: one chunk of 64 a product (f 128: two); d 256: splits of 2, f 512: of 3
    cps = (1, 1, 1, 1) if hd == 32 else (2, 2, 2, 3)
    out = walk_stack(pack, *args, 3, Kb, scaling, cps)
    for name, a, b in zip(("x_out", "k_new", "v_new"), out, ref):
        err, lim = _bf16_err(a, np.asarray(b.astype(jnp.float32)))
        assert err <= lim, f"hd{hd} {name}: {err} > {lim}"


# ---------------------------------------------------------------------------
# (iii) the model at hd 128 and at JAX's hd 16
# ---------------------------------------------------------------------------

MODELS = {
    "hd128": lambda: dataclasses.replace(
        jc.ofa_tiny(), embed_dim=256, ffn_dim=1024, attention_heads=2, encoder_layers=2,
        decoder_layers=2, resnet_layers=(1, 1, 1), dtype="float32", use_flash_attention=True),
    "hd16": lambda: tiny_cfg(use_flash_attention=True),
}


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """One configuration's parameters, drawn by the port's seeded init in the
    JAX layout (the JAX init's tree structure and shapes, checked), random
    rel-pos tables and BN statistics; each JAX program compiles once."""
    cfg_j = MODELS[request.param]()
    assert cfg_j.head_dim == {"hd128": 128, "hd16": 16}[request.param]
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    tree = init_ofa_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    params_np = _randomize(jax.tree.map(lambda a: a.numpy(), tree), np.random.RandomState(7))
    shapes = jax.eval_shape(lambda k: jofa.init_ofa_params(k, cfg_j), jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params_np)
    assert [a.shape for a in jax.tree.leaves(shapes)] == \
        [a.shape for a in jax.tree.leaves(params_np)]
    src, imgs, masks = (np.array(a) for a in make_batch(cfg_j, B=2, T=8, img=64))
    params_j = jax.tree.map(jnp.asarray, params_np)
    enc_j = jax.jit(jofa.encode, static_argnums=1)(
        params_j, cfg_j, jnp.asarray(src), jnp.asarray(imgs), jnp.asarray(masks))
    return dict(name=request.param, cfg_j=cfg_j, cfg_t=cfg_t, params_np=params_np,
                params_j=params_j, params_t=from_jax(params_np, cfg_t, "cpu", torch.float32),
                src=src, imgs=imgs, masks=masks, enc_j=enc_j)


def test_any_head_dim_encode_and_beam_search_match_jax(pair):
    p, enc_j = pair, pair["enc_j"]
    enc_t = ofa.encode(p["params_t"], p["cfg_t"], torch.from_numpy(p["src"]),
                       torch.from_numpy(p["imgs"]), torch.from_numpy(p["masks"]))
    assert _rel_err(enc_t.x.numpy(), enc_j.x) <= REL_TOL, p["name"]
    kw = dict(beam_size=5, max_len_b=8, min_len=1, no_repeat_ngram_size=3)
    toks_j, sc_j = jax_beam_search(p["params_j"], p["cfg_j"], JaxGenerationConfig(**kw), enc_j,
                                   max_len=8)
    toks_t, sc_t = beam_search(p["params_t"], p["cfg_t"], GenerationConfig(**kw), enc_t,
                               max_len=8)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    assert _rel_err(sc_t.numpy(), sc_j) <= REL_TOL, p["name"]


def test_any_head_dim_serving_b_decode_steps_match_jax(pair):
    """Serving B (``decode_stack_kernel``): two chained steps at beam 3, the
    samples even, so both sides run K7 (the port its plain version): logits
    and self caches."""
    p, enc_j = pair, pair["enc_j"]
    cfg_j, cfg_t = (dataclasses.replace(p[c], decode_stack_kernel=True)
                    for c in ("cfg_j", "cfg_t"))
    K, max_len = 3, 4
    enc_t = ofa.EncoderOut(*(torch.from_numpy(np.array(a)) for a in enc_j))
    st_j = jofa.init_decoder_state(p["params_j"], cfg_j, enc_j, max_len, beam_size=K)
    st_t = ofa.init_decoder_state(p["params_t"], cfg_t, enc_t, max_len, beam_size=K)
    assert st_t.kernel_pack is not None
    toks = np.random.RandomState(3).randint(4, cfg_j.vocab_size, (2, 2 * K))
    step_j = jax.jit(jofa.decode_step, static_argnums=1)
    for step in range(2):
        lj, st_j = step_j(p["params_j"], cfg_j, jnp.asarray(toks[step]), jnp.int32(step), st_j)
        lt, st_t = ofa.decode_step(p["params_t"], cfg_t, torch.from_numpy(toks[step]), step, st_t)
        assert _rel_err(lt.numpy(), lj) <= REL_TOL, f"{p['name']} step {step} logits"
        for name in ("self_k", "self_v"):
            assert _rel_err(st_t.cache[name].numpy(), st_j.cache[name]) <= REL_TOL, name


CRIT = dict(label_smoothing=0.1)


def test_any_head_dim_joint_step_loss_and_gradients_match_jax(pair):
    """The loss and gradients of JAX's joint step (``multitask_loss`` under
    ``jax.value_and_grad``, one compile) against the port's ``multitask_loss``
    and its backward through K3/K4's plain versions, on one caption batch."""
    cfg_j, cfg_t = pair["cfg_j"], pair["cfg_t"]
    nb = {"caption": _np_batch(np.random.RandomState(3), cfg_j, 2, 8, 5, img=True)}
    for k in ("src_tokens", "prev_output_tokens", "target"):  # into the vocabulary
        a = nb["caption"][k]
        a[a >= 4] = 4 + (a[a >= 4] - 4) % (cfg_j.vocab_size - 4)
    micro_j = {n: jax.tree.map(lambda a: a[0], b) for n, b in _jax_batches(nb).items()}
    crit = jc.CriterionConfig(**CRIT)
    (loss_j, m_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p, m: jax_multitask_loss(p, cfg_j, crit, m, jax.random.PRNGKey(1), jnp.int32(0)),
        has_aux=True))(pair["params_j"], micro_j)
    params_t = trainable(from_jax(pair["params_np"], cfg_t, "cpu", torch.float32))
    lt, mt = multitask_loss(params_t, cfg_t, tc.CriterionConfig(**CRIT),
                            _micro(_torch_batches(nb)), torch.Generator().manual_seed(0), 0)
    lt.backward()
    assert _rel(lt, loss_j) <= 1e-5
    assert set(mt) == set(m_j)
    for k, v in m_j.items():
        assert _rel(mt[k], v) <= 1e-5, k
    grads_t = [(path, p.grad) for path, p in named_leaves(params_t)]
    grads_j = named_leaves(from_jax(jax.tree.map(np.asarray, grads_j), cfg_t, "cpu",
                                    torch.float32))
    gnorm_j = float(np.sqrt(sum(float((g.double() ** 2).sum()) for _, g in grads_j)))
    gnorm_t = float(global_norm([g for _, g in grads_t if g is not None]))
    assert _rel(gnorm_t, gnorm_j) <= 1e-5
    floor = 1e-4 * max(float(np.abs(g.numpy()).max()) for _, g in grads_j)
    for (path, gt), (_, gj) in zip(grads_t, grads_j):
        gj = gj.numpy()
        gt = np.zeros_like(gj) if gt is None else gt.numpy()
        scale = max(float(np.abs(gj).max()), floor)
        assert _err(gt, gj) <= 5e-4 * scale, f"{path}: {_err(gt, gj)} vs max |g| {scale}"


# ---------------------------------------------------------------------------
# (iv) no card
# ---------------------------------------------------------------------------

def test_zero_padded_copy_is_the_plain_version_at_head_dim_20():
    """The wrappers' padded copy at D 20 (to 24; K6's int8 cache to 32): pad,
    run the plain version, slice, against the plain version on the unpadded
    streams, fp32, for K1, K3/K4, K5 and K6."""
    D = 20
    t = _torch_args(_inputs(T=33, S=41, D=D), torch.float32)
    pad = lambda xs, unit=8: [_build.pad_head(a, unit) if a is not None and a.dim() == 4 else a
                              for a in xs]
    assert _build.pad_head(t[0]).shape[-1] == 24 and _build.pad_head(t[0], 16).shape[-1] == 32
    x16 = t[0][..., :16].contiguous()
    assert _build.pad_head(x16) is x16  # a multiple of 8: the stream itself, no copy
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    close(k1.flash_attention_plain(*pad(t))[..., :D], k1.flash_attention_plain(*t))
    o, lse = kb.flash_attention_fwd_plain(*t, causal=True)
    o_p, lse_p = kb.flash_attention_fwd_plain(*pad(t), causal=True)
    close(o_p[..., :D], o)
    close(lse_p, lse)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(2))
    grads = kb.flash_attention_bwd_plain(*t, o, lse, do, causal=True)
    grads_p = kb.flash_attention_bwd_plain(*pad(t), *pad([o]), lse, *pad([do]), causal=True)
    for name, a, b in zip(GRADS, grads_p, grads):
        if a.dim() == 4:
            assert not a[..., D:].any(), name
            a = a[..., :D]
        close(a, b)
    close(k5.flash_cross_attention_plain(*pad(t[:5]), t[6])[..., :D],
          k5.flash_cross_attention_plain(*t[:5], t[6]))
    x6 = _k6_inputs(B=2, H=2, Kb=3, S=9, D=D, full_pad=None)
    a6 = [torch.from_numpy(x6[n]) for n in K6_NAMES]
    out = k6.decode_cross_attention_int8_plain(*pad(a6[:3], 16), *a6[3:])
    close(out[..., :D], k6.decode_cross_attention_int8_plain(*a6))


def test_head_dim_instances_and_shared_memory_plans():
    """Every head dim 1 to 256 runs on the smallest instance covering it
    rounded up to 8 (K6's int8 rows: 16); 0 raises, 257 runs on the deep
    route (``test_torch_port_head_dims_deep.py``); each instance's
    shared memory fits a block (K1, K3, K5 two CTAs an SM below 128, K4 and
    the K6 and K7 cross-attentions at the serving shape, B16 Kb5 S908; K6
    two CTAs an SM below 128)."""
    assert _build.HEAD_DIMS == (32, 64, 80, 128, 192, 256) and _build.MAX_INSTANCE == 256
    for D in range(1, 257):
        _build.check_head_dim("k", D)
        r8 = -(-D // 8) * 8
        assert _build.head_instance(D) == min(n for n in _build.HEAD_DIMS if n >= r8), D
        assert _build.head_instance(D, 16) == min(n for n in _build.HEAD_DIMS
                                                  if n >= -(-D // 16) * 16), D
    with pytest.raises(NotImplementedError, match=r"head dim 0; .*from 1 upward"):
        _build.check_head_dim("k", 0)
    _build.check_head_dim("k", 257)
    assert _build.head_instance(257) == _build.DEEP
    per_sm = 233472  # an SM's shared memory; each CTA also reserves 1 KB
    smem = {dp: k1.sm90_smem(dp) for dp in _build.HEAD_DIMS}
    # 192 and 256: the pair route's CTA (test_torch_port_head_dims_wide.py)
    assert smem == {32: 46136, 64: 91192, 80: 113720, 128: 181304, 192: 231320, 256: 231320}
    for dp in _build.HEAD_DIMS:
        assert k1.sm90_smem(dp - 8) == smem[dp] or dp == 32  # a head dim runs on its instance
        assert (2 if dp < 128 else 1) * (smem[dp] + 1024) <= per_sm, dp
        assert k1.sm90_smem(dp, bwd=True) <= _build.SMEM_MAX, dp
        assert (2 if dp < 128 else 1) * (k6.sm90_smem(5, 908, dp) + 1024) <= per_sm, dp
        assert k7._cross_smem(5, 908, dp) <= _build.SMEM_MAX, dp
    assert k7._cross_smem(5, 908, 128) == 164944 and k7._cross_smem(5, 908, 100) == 164944
    assert k6.sm90_smem(5, 908, 8) == k6.sm90_smem(5, 908, 32)
