"""The port at head dim 80 (``ofa_huge``'s) against the JAX package, on the CPU.

The attention kernels (K1, K3, K4, K5, K6, K7) are compiled for the head
dims ``_build.HEAD_DIMS``, 64 and 80. At 80 a bf16 row is 160 bytes: the
tensor-core cores load each tile as two boxes (columns 0..63 under the
128-byte swizzle, 64..79 under the 32-byte one), take D / 16 = 5 k-steps per
product, and K6 permutes five int8 words a lane. The kernels run only on the
card; here, on the same seeded numpy inputs:

- (i) the tile walks of K1 and K3/K4 (``test_torch_port_attention_walk.py``,
  ``test_torch_port_attention_bwd_walk.py``) at D 80 against the Pallas
  kernels in interpret mode, in bf16, to chip_smoke.py's tolerance (2⁻⁶ of
  max(1, max|ref|));
- (ii) the K6 and K7 walks (``test_torch_port_int8_decode_walk.py``,
  ``test_torch_port_decode_walk.py``) at hd 80 against the JAX kernels, one
  step each, to the same tolerance;
- (iii) ``ofa_tiny`` widened to hd 80 (d 320, 4 heads, ffn 1280; 2 + 2
  layers, ResNet (1, 1, 1), 64² images), float32, the JAX tree bridged by
  ``from_jax``: encode and beam search against the JAX flash branch (tokens
  exactly, encoder features and beam scores within 1e-5 of max|ref|), two
  serving-B decode steps (``decode_stack_kernel``: logits and self caches
  within 1e-5 of max|ref|), and the joint step's loss, per-task losses and
  gradient norm within 1e-5 relative of JAX's, every gradient leaf within
  5e-4 of its largest |g| (the bound of ``test_torch_port_train.py``);
- (iv) with no card: the head-dim check (64, 80, 72, 8 and 136 pass, 264 raises
  ``NotImplementedError`` naming the range, before any device check) and the
  shared-memory planners at ``ofa_huge``'s shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from musketeer_tpu_torch.ops import flash_attention_infer as k1
from musketeer_tpu_torch.ops import topk_projection as k2
from musketeer_tpu_torch.params import from_jax, init_ofa_params, trainable
from musketeer_tpu_torch.training.train_state import global_norm, named_leaves
from musketeer_tpu_torch.training.train_step import multitask_loss
from tests.test_model import make_batch
from tests.test_torch_port_attention_bwd_walk import GRADS, walk_bwd
from tests.test_torch_port_attention_walk import TOL, walk
from tests.test_torch_port_decode_walk import walk_stack
from tests.test_torch_port_int8_decode_walk import walk_k6
from tests.test_torch_port_model import REL_TOL, _randomize, _rel_err
from tests.test_torch_port_normformer import one_thread  # noqa: F401  (fixture)
from tests.test_torch_port_serving_kernels import K6_NAMES, _k6_inputs
from tests.test_torch_port_train import _err, _jax_batches, _micro, _np_batch, _rel, _torch_batches
from tests.test_torch_port_train_kernels import _inputs, _jax_args, _torch_args

HD = 80
NAMES = ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")
# (i): a non-causal case with rel and padded keys over ragged tiles, and a causal one
ATTN_CASES = {"rel_padded": dict(T=70, S=70), "causal": dict(T=40, S=40, causal=True)}


def _bf16_err(out: torch.Tensor, ref) -> tuple:
    ref = np.asarray(ref, np.float32)
    assert tuple(out.shape) == ref.shape
    err = float(np.abs(out.float().numpy() - ref).max())
    return err, TOL * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_k1_walk_at_hd80_matches_jax_kernel(case):
    c = ATTN_CASES[case]
    x = _inputs(D=HD, **c)
    causal = c.get("causal", False)
    ref = jax_k1(*_jax_args(x, jnp.bfloat16), causal=causal)
    out = walk(*_torch_args(x, torch.bfloat16), causal=causal)
    err, lim = _bf16_err(out, ref)
    assert out.dtype == torch.bfloat16 and err <= lim, f"{case}: {err} > {lim}"


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_k3_k4_walks_at_hd80_match_jax_kernels(case):
    c = ATTN_CASES[case]
    x = _inputs(D=HD, **c)
    causal = c.get("causal", False)
    B, _, T, _ = x["q"].shape
    o_j, res = jax_fwd(*_jax_args(x, jnp.bfloat16), causal, 128, True, want_res=True)
    lse_j = np.array(res[6])[:B, :, :T, 0]
    t = _torch_args(x, torch.bfloat16)
    o_w, lse_w = walk(*t, causal=causal, want_lse=True)  # K3: K1's walk with its lse
    err, lim = _bf16_err(o_w, o_j)
    assert err <= lim, f"{case} o: {err} > {lim}"
    assert float(np.abs(lse_w.numpy() - lse_j).max()) <= 1e-4 * max(1.0, np.abs(lse_j).max())
    ref = jax_bwd(res, causal, 128, True, True, jnp.asarray(x["do"], jnp.bfloat16))
    out = walk_bwd(*t, torch.from_numpy(np.asarray(o_j, np.float32)).to(torch.bfloat16),
                   torch.from_numpy(lse_j), torch.from_numpy(x["do"]).to(torch.bfloat16),
                   causal=causal)
    for name, a, b in zip(GRADS, out, ref):
        err, lim = _bf16_err(a, b)
        assert err <= lim, f"{case} {name}: {err} > {lim}"


def test_k6_walk_at_hd80_matches_jax_kernel():
    x = _k6_inputs(B=3, H=2, Kb=5, S=150, D=HD, full_pad=2, seed=5)
    args = [torch.from_numpy(x["q"]).to(torch.bfloat16)] + \
        [torch.from_numpy(x[n]) for n in K6_NAMES[1:]]
    out = walk_k6(*args)
    ref = np.asarray(jax_k6(jnp.asarray(x["q"], jnp.bfloat16),
                            *(jnp.asarray(x[n]) for n in K6_NAMES[1:])).astype(jnp.float32))
    live = [b for b in range(ref.shape[0]) if not x["enc_pad"][b].all()]
    err, lim = _bf16_err(out[live], ref[live])
    assert err <= lim, f"{err} > {lim}"
    assert (out[2] == 0).all()  # the fully padded sample (JAX on XLA:CPU gives NaN there)


def _stack_inputs_hd80():
    """A 2-layer stack at hd 80 (d 320, H 4, f 640), rows 6 = 2 samples x 3 beams."""
    L, B, Kb, H, f, Tmax, S = 2, 2, 3, 4, 640, 6, 24
    d, rows = H * HD, B * Kb
    rng = np.random.RandomState(8)
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
             self_k=rng.randn(L, rows, H, Tmax, HD), self_v=rng.randn(L, rows, H, Tmax, HD),
             cross_k=rng.randn(L, B, H, S, HD), cross_v=rng.randn(L, B, H, S, HD))
    x = {n: a.astype(np.float32) for n, a in x.items()}
    port_layers = [jax.tree.map(lambda a: torch.from_numpy(np.ascontiguousarray(
        a[i].T if a.ndim == 3 else a[i])), layers) for i in range(L)]
    return layers, port_layers, x, Kb, float(HD * 2.0) ** -0.5


def test_k7_walk_at_hd80_matches_jax_kernel():
    layers, port_layers, x, Kb, scaling = _stack_inputs_hd80()
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
    # 5 chunks of 64 over d 320 and 10 over f 640: splits of 2 and of 3
    out = walk_stack(pack, *args, 3, Kb, scaling, (2, 3, 2, 3))
    for name, a, b in zip(("x_out", "k_new", "v_new"), out, ref):
        err, lim = _bf16_err(a, np.asarray(b.astype(jnp.float32)))
        assert err <= lim, f"{name}: {err} > {lim}"


# ---------------------------------------------------------------------------
# (iii) the model at hd 80
# ---------------------------------------------------------------------------

def _hd80_cfg():
    cfg = dataclasses.replace(jc.ofa_tiny(), embed_dim=320, ffn_dim=1280, attention_heads=4,
                              encoder_layers=2, decoder_layers=2, resnet_layers=(1, 1, 1),
                              dtype="float32", use_flash_attention=True)
    assert cfg.head_dim == HD
    return cfg


@pytest.fixture(scope="module")
def pair():
    """The parameters drawn by the port's seeded init in the JAX layout (the
    JAX init's tree structure and shapes, checked; drawn in a fraction of the
    time of JAX's init), random rel-pos tables and BN statistics."""
    cfg_j = _hd80_cfg()
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    tree = init_ofa_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    params_np = _randomize(jax.tree.map(lambda a: a.numpy(), tree), np.random.RandomState(7))
    shapes = jax.eval_shape(lambda k: jofa.init_ofa_params(k, cfg_j), jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params_np)
    assert [a.shape for a in jax.tree.leaves(shapes)] == \
        [a.shape for a in jax.tree.leaves(params_np)]
    src, imgs, masks = (np.array(a) for a in make_batch(cfg_j, B=2, T=8, img=64))
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params_np=params_np,
                params_j=jax.tree.map(jnp.asarray, params_np),
                params_t=from_jax(params_np, cfg_t, "cpu", torch.float32),
                src=src, imgs=imgs, masks=masks)


@pytest.fixture(scope="module")
def encoded(pair):
    p = pair
    enc_j = jax.jit(jofa.encode, static_argnums=1)(
        p["params_j"], p["cfg_j"], jnp.asarray(p["src"]), jnp.asarray(p["imgs"]),
        jnp.asarray(p["masks"]))
    enc_t = ofa.encode(p["params_t"], p["cfg_t"], torch.from_numpy(p["src"]),
                       torch.from_numpy(p["imgs"]), torch.from_numpy(p["masks"]))
    return enc_j, enc_t


def test_hd80_encode_and_beam_search_match_jax(pair, encoded):
    p, (enc_j, enc_t) = pair, encoded
    assert _rel_err(enc_t.x.numpy(), enc_j.x) <= REL_TOL
    kw = dict(beam_size=5, max_len_b=8, min_len=1, no_repeat_ngram_size=3)
    toks_j, sc_j = jax_beam_search(p["params_j"], p["cfg_j"], JaxGenerationConfig(**kw), enc_j,
                                   max_len=8)
    toks_t, sc_t = beam_search(p["params_t"], p["cfg_t"], GenerationConfig(**kw), enc_t,
                               max_len=8)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    assert _rel_err(sc_t.numpy(), sc_j) <= REL_TOL


def test_hd80_serving_b_decode_steps_match_jax(pair, encoded):
    """Serving B (``decode_stack_kernel``): two chained steps at beam 3, the
    samples even, so both sides run K7 (the port its plain version): logits
    and self caches."""
    p, (enc_j, _) = pair, encoded
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
        assert _rel_err(lt.numpy(), lj) <= REL_TOL, f"step {step} logits"
        for name in ("self_k", "self_v"):
            assert _rel_err(st_t.cache[name].numpy(), st_j.cache[name]) <= REL_TOL, name


CRIT = dict(label_smoothing=0.1)


def test_hd80_joint_step_loss_and_gradients_match_jax(pair):
    """The loss and gradients of JAX's joint step (``multitask_loss`` under
    ``jax.value_and_grad``, as ``make_train_step`` takes them; one compile)
    against the port's ``multitask_loss`` and its backward through K3/K4's
    plain versions, on one caption batch."""
    cfg_j, cfg_t = pair["cfg_j"], pair["cfg_t"]
    nb = {"caption": _np_batch(np.random.RandomState(3), cfg_j, 2, 8, 5, img=True)}
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

def test_head_dim_check_takes_every_head_dim_from_1_and_refuses_0():
    """The head-dim contract: every head dim from 1 upward passes (72, 8 and
    136 among them, on the instances 80, 32 and 192, and 264 on the deep
    route), 0 raises naming the range."""
    assert _build.HEAD_DIMS == (32, 64, 80, 128, 192, 256)
    for hd in (64, 80, 72, 8, 136, 264):
        _build.check_head_dim("k", hd)
    assert [_build.head_instance(hd) for hd in (64, 80, 72, 8, 136, 264)] == \
        [64, 80, 80, 32, 192, _build.DEEP]
    with pytest.raises(NotImplementedError, match=r"head dim 0; .*from 1 upward"):
        _build.check_head_dim("k", 0)
    # the attention wrappers' CUDA checks refuse 0 first, before any device
    # check, and take 264 on to the device check (here: CPU tensors)
    kpad = torch.zeros(1, 8, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="head dim 0"):
        q = torch.empty(1, 2, 8, 0)
        k1.cuda_args("flash_attention_inference", q, q, q, q, q, None, kpad)
    q = torch.empty(1, 2, 8, 264)
    with pytest.raises(ValueError, match="unsupported device"):
        k1.cuda_args("flash_attention_inference", q, q, q, q, q, None, kpad)
    x = torch.empty(10, 528)
    stack = dict(x0=x, sbias=torch.empty(1, 10, 2, 4), cbias=torch.empty(2, 2, 8),
                 self_k=torch.empty(1, 10, 2, 4, 264), self_v=torch.empty(1, 10, 2, 4, 264),
                 cross_k=torch.empty(1, 2, 2, 8, 264), cross_v=torch.empty(1, 2, 2, 8, 264))
    with pytest.raises(ValueError, match="unsupported device"):
        k7._check_cuda({}, *stack.values(), cache_index=0, beam_size=5)
    stack.update(x0=torch.empty(10, 0), self_k=torch.empty(1, 10, 2, 4, 0))
    with pytest.raises(NotImplementedError, match="head dim 0"):
        k7._check_cuda({}, *stack.values(), cache_index=0, beam_size=5)
    # on CPU tensors the plain versions take any head dim
    x6 = _k6_inputs(B=2, H=2, Kb=3, S=9, D=72, full_pad=None)
    out = k6.decode_cross_attention_int8(*(torch.from_numpy(x6[n]) for n in K6_NAMES))
    assert tuple(out.shape) == (2, 2, 3, 72)


def test_shared_memory_plans_fit_at_ofa_huge():
    per_sm = 233472  # an SM's shared memory; each CTA also reserves 1 KB
    for D in (64, 80):
        # K1, K3, K5: two CTAs an SM; K4: one
        assert 2 * (k1.sm90_smem(D) + 1024) <= per_sm, D
        assert k1.sm90_smem(D, bwd=True) <= _build.SMEM_MAX, D
    assert k1.sm90_smem(64) == 91192 and k1.sm90_smem(80) == 113720
    # K6 at ofa_huge's serving shape (B16 H16 Kb5 S908): two CTAs an SM, so
    # its 256 CTAs run in one wave on 132 SMs
    assert 2 * (k6.sm90_smem(5, 908, HD) + 1024) <= per_sm
    assert k6.sm90_smem(5, 908) == k6.sm90_smem(5, 908, 64)
    # K7's cross-attention at rows 80, S908
    assert k7._cross_smem(5, 908, HD) <= _build.SMEM_MAX
    # K2 and K2-q8 at d 1280: h of 80 rows no longer fits, 48 does
    assert k2.proj_plan(80, 1280, 132, 59520) == (48, 132, False)
    assert k2.proj_plan(80, 1280, 132, 59520, q8=True) == (48, 132, False)


def test_k6_head_dim_permutation_at_hd80():
    """K6 at D 80: lane quad t's int8 word j holds dims 20 t + 4 j .. + 3, and
    its k-slots 2t, 2t+1, 2t+8, 2t+9 of k-step j are dims 20 t + 4 j + e,
    e = 0, 1, 2, 3: a bijection of the 80 dims that q's fragments follow."""
    span = HD // 4
    phys = {}
    for j in range(HD // 16):
        for s in range(16):
            t, e = (s % 8) // 2, s % 2 + 2 * (s // 8)
            phys[16 * j + s] = span * t + 4 * j + e
    assert sorted(phys.values()) == list(range(HD))
    for j in range(HD // 16):
        for t in range(4):
            # q's uint2 at element D / 4 t + 4 j: a0 = (2t, 2t+1), a2 = (2t+8, 2t+9)
            assert [phys[16 * j + 2 * t], phys[16 * j + 2 * t + 1]] == \
                [span * t + 4 * j, span * t + 4 * j + 1]
            assert [phys[16 * j + 2 * t + 8], phys[16 * j + 2 * t + 9]] == \
                [span * t + 4 * j + 2, span * t + 4 * j + 3]
