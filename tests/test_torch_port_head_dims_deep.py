"""The port at head dims past 256 against the JAX package, on the CPU.

Past ``_build.MAX_INSTANCE`` (256) the attention kernels (K1, K3, K4, K5, K6,
K7) run on the deep route: the head dim streams through every product in
chunks of 128 columns (the last zero-filled past D), the score (and K4's dP)
summed over the chunks in the k-step order of one whole-width product, and
each output's columns split into blocks of 128. The bf16 K1/K3/K5 and K4
kernels group up to three blocks in a CTA, whose builder warpgroup builds
each score tile (K4: S and dP) once for all of them
(``flash_attention_infer.deep_plan``); K6 and K7 compute the scores again in
every block. So a score is the sum a whole-width tile of
``deep_chunks(D) * 128`` columns would give, and every output element the
sum of its block alone. The kernels run only on the card; here, on the same
seeded numpy inputs:

- (i) the tile walks of K1 and K3/K4 (``test_torch_port_attention_walk.py``,
  ``test_torch_port_attention_bwd_walk.py``) at D 384 (causal) and 520 (rel,
  padded keys; a short last chunk), T = S = 70, on the streams zero-filled to
  whole chunks, against the Pallas kernels in interpret mode, in bf16, to
  chip_smoke.py's tolerance (2⁻⁶ of max(1, max|ref|)); K1's walk also block
  by block, each 128 columns of v alone, bit-equal to the whole;
- (ii) the K6 and K7 walks at hd 384 against the JAX kernels;
- (iii) ``ofa_tiny`` widened to hd 384 (d 384, 1 head; 2 + 2 layers, ResNet
  (1, 1, 1), 64² images), float32, the JAX tree bridged by ``from_jax``:
  encode and beam search against the JAX flash branch (tokens exactly,
  encoder features and beam scores within 1e-5 of max|ref|), two serving-B
  decode steps, and the joint step's loss and gradients to the bounds of
  ``test_torch_port_head_dim.py``; each JAX program compiled once;
- (iv) with no card: the route, chunk count and column blocks of every head
  dim 257 to 1280; the groups of column blocks a CTA owns (D 384, 520,
  1280, the last group ragged); the deep plan of K1, K5 and K4 at every such head dim
  (blocks a CTA owns, CTAs per tile, score and dP builds per tile, bytes
  streamed at the caption and training shapes); and the shared-memory
  planners at chip_smoke.py phase 29's serving and training shapes, their
  bytes against the layouts of the CUDA sources.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from musketeer_tpu import config as jc
from musketeer_tpu.ops.decode_cross_attn import decode_cross_attention_int8 as jax_k6
from musketeer_tpu.ops.decode_stack import decode_stack_step as jax_k7
from musketeer_tpu.ops.decode_stack import pack_decoder_weights as jax_pack
from musketeer_tpu.ops.decode_stack import transpose_cross_kv
from musketeer_tpu.ops.flash_attention_bwd import _bwd as jax_bwd
from musketeer_tpu.ops.flash_attention_bwd import _fwd as jax_fwd
from musketeer_tpu.ops.flash_attention_infer import flash_attention_inference as jax_k1
from musketeer_tpu_torch.ops import _build
from musketeer_tpu_torch.ops import decode_cross_attn as k6
from musketeer_tpu_torch.ops import decode_stack as k7
from musketeer_tpu_torch.ops import flash_attention_infer as k1
from tests.test_torch_port_attention_bwd_walk import GRADS, walk_bwd
from tests.test_torch_port_attention_walk import walk
from tests.test_torch_port_decode_walk import walk_stack
from tests.test_torch_port_head_dims_any import _bf16_err, _stack_inputs
from tests.test_torch_port_head_dims_any import \
    test_any_head_dim_encode_and_beam_search_match_jax as _encode_and_beam
from tests.test_torch_port_head_dims_any import \
    test_any_head_dim_joint_step_loss_and_gradients_match_jax as _joint_step
from tests.test_torch_port_head_dims_any import \
    test_any_head_dim_serving_b_decode_steps_match_jax as _serving_b
from tests.test_torch_port_int8_decode_walk import walk_k6
from tests.test_torch_port_model import _randomize
from tests.test_torch_port_normformer import one_thread  # noqa: F401  (fixture)
from tests.test_torch_port_serving_kernels import K6_NAMES, _k6_inputs
from tests.test_model import make_batch
from tests.test_torch_port_train_kernels import _inputs, _jax_args, _torch_args

# (i): one case a head dim: causal at 384, rel with padded keys at 520
WALKS = {384: dict(T=70, S=70, causal=True), 520: dict(T=70, S=70)}
N_SM = 132  # an H100 SXM's SMs: the split-K plans of K7's products
CHUNK = _build.DEEP_CHUNK


def _walk_inputs(D: int) -> dict:
    """WALKS[D]'s inputs; causal, the first key unpadded, so that no query
    row is fully masked (the JAX training kernel spreads such a row over its
    padded keys: ``test_torch_port_train_kernels.py`` keeps those cases)."""
    x = _inputs(D=D, **WALKS[D])
    if WALKS[D].get("causal"):
        x["kpad"][:, 0] = False
    return x


def _chunks(t, D: int):
    """A stream as the deep route's chunks hold it: zeros past D to whole chunks."""
    if t is None or t.dim() != 4:
        return t
    return F.pad(t, (0, _build.deep_chunks(D) * CHUNK - D))


@pytest.mark.parametrize("D", list(WALKS))
def test_k1_walk_past_256_matches_jax_kernel_and_its_column_blocks(D):
    x, causal = _walk_inputs(D), WALKS[D].get("causal", False)
    ref = jax_k1(*_jax_args(x, jnp.bfloat16), causal=causal)
    t = [_chunks(a, D) for a in _torch_args(x, torch.bfloat16)]
    out = walk(*t, causal=causal)
    err, lim = _bf16_err(out[..., :D], ref)
    assert out.dtype == torch.bfloat16 and err <= lim, f"D{D}: {err} > {lim}"
    # a CTA's block: the same scores against v's 128 columns of that block alone
    nch = _build.col_halves(D)
    assert nch == _build.deep_chunks(D) == -(-D // 128)

    def block(c0):  # v's columns c0 .. c0 + 127 alone (zeros elsewhere)
        v = torch.zeros_like(t[2])
        v[..., :CHUNK] = t[2][..., c0:c0 + CHUNK]
        return walk(*t[:2], v, *t[3:], causal=causal)[..., :CHUNK]

    whole = torch.cat([block(CHUNK * c) for c in range(nch)], -1)
    assert torch.equal(whole[..., :D], out[..., :D])


# a CTA's group of column blocks sharing one score tile: D 384 one group of
# three, 520 three and a ragged two, 1280 three groups of three and one of one
GROUPS = {384: [3], 520: [3, 2], 1280: [3, 3, 3, 1]}


@pytest.mark.parametrize("D", list(GROUPS))
def test_deep_groups_give_each_cta_its_column_blocks(D):
    """Each CTA of the deep route owns a group of column blocks
    (``deep_groups``), the last group ragged; the plans of K1, K5 and K4 give
    that many CTAs per tile and the last group's blocks."""
    assert k1.deep_groups(D) == GROUPS[D]
    for kernel in ("K1", "K5", "K4"):
        p = k1.deep_plan(D, kernel)
        ctas = p["ctas_per_q_tile"] // 2 if kernel == "K4" else p["ctas_per_tile"]
        assert (ctas, p["last_blocks"]) == (len(GROUPS[D]), GROUPS[D][-1]), kernel


@pytest.mark.parametrize("D", list(WALKS))
def test_k3_k4_walks_past_256_match_jax_kernels(D):
    x, causal = _walk_inputs(D), WALKS[D].get("causal", False)
    B, _, T, _ = x["q"].shape
    o_j, res = jax_fwd(*_jax_args(x, jnp.bfloat16), causal, 128, True, want_res=True)
    lse_j = np.array(res[6])[:B, :, :T, 0]
    t = [_chunks(a, D) for a in _torch_args(x, torch.bfloat16)]
    o_w, lse_w = walk(*t, causal=causal, want_lse=True)  # K3: K1's walk with its lse
    err, lim = _bf16_err(o_w[..., :D], o_j)
    assert err <= lim, f"D{D} o: {err} > {lim}"
    assert float(np.abs(lse_w.numpy() - lse_j).max()) <= 1e-4 * max(1.0, np.abs(lse_j).max())
    ref = jax_bwd(res, causal, 128, True, True, jnp.asarray(x["do"], jnp.bfloat16))
    o = torch.from_numpy(np.asarray(o_j, np.float32)).to(torch.bfloat16)
    do = torch.from_numpy(x["do"]).to(torch.bfloat16)
    out = walk_bwd(*t, _chunks(o, D), torch.from_numpy(lse_j), _chunks(do, D), causal=causal)
    for name, a, b in zip(GRADS, out, ref):
        if a.dim() == 4:
            assert not a[..., D:].any(), f"D{D} {name}: the zero columns got a gradient"
            a = a[..., :D]
        err, lim = _bf16_err(a, b)
        assert err <= lim, f"D{D} {name}: {err} > {lim}"


def test_k6_walk_at_hd384_matches_jax_kernel():
    x = _k6_inputs(B=3, H=2, Kb=5, S=150, D=384, full_pad=2, seed=6)
    args = [torch.from_numpy(x["q"]).to(torch.bfloat16)] + \
        [torch.from_numpy(x[n]) for n in K6_NAMES[1:]]
    out = walk_k6(*args)
    ref = np.asarray(jax_k6(jnp.asarray(x["q"], jnp.bfloat16),
                            *(jnp.asarray(x[n]) for n in K6_NAMES[1:])).astype(jnp.float32))
    live = [b for b in range(ref.shape[0]) if not x["enc_pad"][b].all()]
    err, lim = _bf16_err(out[live], ref[live])
    assert err <= lim, f"{err} > {lim}"
    assert (out[2] == 0).all()  # the fully padded sample (JAX on XLA:CPU gives NaN there)


def test_k7_walk_at_hd384_matches_jax_kernel():
    hd = 384
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
    # d 768, f 1536 at rows 6: the splits an H100's 132 SMs give each product
    rows, d = args[0].shape
    cps = tuple(k7.split_plan(dout, K, rows, N_SM)
                for dout, K in k7._products(d, 2 * d).values())
    out = walk_stack(pack, *args, 3, Kb, scaling, cps)
    for name, a, b in zip(("x_out", "k_new", "v_new"), out, ref):
        err, lim = _bf16_err(a, np.asarray(b.astype(jnp.float32)))
        assert err <= lim, f"hd{hd} {name}: {err} > {lim}"


# ---------------------------------------------------------------------------
# (iii) the model at hd 384
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """ofa_tiny at d 384 in one head of 384: parameters drawn by the port's
    seeded init in the JAX layout, random rel-pos tables and BN statistics;
    each JAX program compiles once."""
    from musketeer_tpu.models import ofa as jofa
    from musketeer_tpu_torch import config as tc
    from musketeer_tpu_torch.params import from_jax, init_ofa_params

    cfg_j = dataclasses.replace(
        jc.ofa_tiny(), embed_dim=384, ffn_dim=1536, attention_heads=1, encoder_layers=2,
        decoder_layers=2, resnet_layers=(1, 1, 1), dtype="float32", use_flash_attention=True)
    assert cfg_j.head_dim == 384
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    tree = init_ofa_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    params_np = _randomize(jax.tree.map(lambda a: a.numpy(), tree), np.random.RandomState(7))
    src, imgs, masks = (np.array(a) for a in make_batch(cfg_j, B=2, T=8, img=64))
    params_j = jax.tree.map(jnp.asarray, params_np)
    enc_j = jax.jit(jofa.encode, static_argnums=1)(
        params_j, cfg_j, jnp.asarray(src), jnp.asarray(imgs), jnp.asarray(masks))
    return dict(name="hd384", cfg_j=cfg_j, cfg_t=cfg_t, params_np=params_np,
                params_j=params_j, params_t=from_jax(params_np, cfg_t, "cpu", torch.float32),
                src=src, imgs=imgs, masks=masks, enc_j=enc_j)


def test_hd384_encode_and_beam_search_match_jax(pair):
    _encode_and_beam(pair)


def test_hd384_serving_b_decode_steps_match_jax(pair):
    _serving_b(pair)


def test_hd384_joint_step_loss_and_gradients_match_jax(pair):
    _joint_step(pair)


# ---------------------------------------------------------------------------
# (iv) no card
# ---------------------------------------------------------------------------

# chip_smoke.py phase 29's head dims and the heads it splits ~768 into
DEEP_DIMS = (264, 300, 384, 520, 576, 768, 1280)


def test_head_dims_past_256_route_chunks_and_column_blocks():
    """Every head dim 257 to 1280 (K6's rows rounded to 16 first) runs on the
    deep route in ceil(D / 128) chunks and as many column blocks; the head
    dims up to 256 keep their instances and halves; the check takes any head
    dim from 1 upward (257, 768, 4096) and refuses 0."""
    for D in range(257, 1281):
        assert _build.head_instance(D) == _build.DEEP == _build.head_instance(D, 16), D
        assert _build.deep_chunks(D) == _build.col_halves(D) == -(-D // 128), D
    assert _build.deep_chunks(264) == 3 and _build.deep_chunks(1280) == 10
    for D in (257, 768, 4096):
        _build.check_head_dim("k", D)
    with pytest.raises(NotImplementedError, match=r"head dim 0; .*from 1 upward"):
        _build.check_head_dim("k", 0)
    assert [_build.head_instance(D) for D in (1, 64, 80, 128, 129, 192, 200, 256)] == \
        [32, 64, 80, 128, 192, 192, 256, 256]
    assert [_build.col_halves(D) for D in (1, 128, 129, 256)] == [1, 1, 2, 2]


def test_deep_shared_memory_plans_match_the_cuda_layouts():
    """The deep route's planners at phase 29's shapes, against the layouts of
    the CUDA sources: K1/K3/K5 (``DeepFwd<false>``: a score ring of 3 slots
    of two 64 x 128 bf16 chunks, a block ring of 2 slots of three, two 64 x
    64 bf16 P tiles, 192 fp32 rows, 14 mbarriers, the slack; up to 3 chunks,
    D <= 384, ``DeepFwd<true>``: q's and pos_q's 6 chunks resident, a key
    ring of 4 single chunks, one block slot, 15 mbarriers), K4's
    key-major kernel (``DeepBwd<false>``: the rings, two P tiles, one staged
    rel tile) and query-major one (``DeepBwd<true>``: the rings, two buffers
    of dW's two parts), the planner's constants as the sources state them;
    K6 and K7's cross-attentions at the serving shape (B16 Kb5 S908: whole
    rows on the instance 128's ring of 8) and at Kb16 S1772 (the
    score-chunked route), and the fp32 cross-attention's chunk (64 dims of
    q, a 128-column block)."""
    csrc = Path(k1.__file__).resolve().parent.parent / "csrc"
    fwd_src = (csrc / "flash_fwd_sm90.cuh").read_text()
    assert int(re.search(r"constexpr int DW = (\d+);", fwd_src)[1]) == k1.DEEP_BLOCKS
    assert int(re.search(r"using ScoreRing = Ring<(\d+), 2 \* CHUNK>;", fwd_src)[1]) == \
        k1.DEEP_SCORE_STAGES
    assert int(re.search(r"using BlockRing = Ring<(\d+), DW \* CHUNK>;", fwd_src)[1]) == \
        k1.DEEP_BLOCK_STAGES
    assert int(re.search(r"constexpr int DEEP_RESIDENT_NK = (\d+);", fwd_src)[1]) == \
        k1.DEEP_RESIDENT_NK
    assert int(re.search(r"using KeyRing = Ring<(\d+), CHUNK>;", fwd_src)[1]) == \
        k1.DEEP_KEY_STAGES
    chunk, ptile, bars, slack, rel = 64 * 128 * 2, 64 * 64 * 2, 8 * 14, 1024, 64 * 72 * 2
    rings = 3 * 2 * chunk + 2 * 3 * chunk
    fwd = rings + 2 * ptile + 3 * 64 * 4 + bars + slack
    fwd_res = 6 * chunk + 4 * chunk + 3 * chunk + 2 * ptile + 3 * 64 * 4 + 8 * 15 + slack
    assert fwd_res == 231288
    kv, qm = rings + 2 * ptile + rel + bars + slack, rings + 2 * 2 * ptile + bars + slack
    assert (fwd, kv, qm) == (214896, 223344, 230512)
    bwd = max(kv, qm)
    assert (k1.deep_plan(384, "K4")["smem_kv"], k1.deep_plan(384, "K4")["smem_q"]) == (kv, qm)
    sp, kb = 960, 5  # S 908 in 64-key tiles; the serving beams
    for D in DEEP_DIMS:
        want = fwd_res if D <= 3 * 128 else fwd
        assert k1.sm90_smem(D) == want <= _build.SMEM_MAX, D
        assert k1.sm90_smem(D, bwd=True) == bwd <= _build.SMEM_MAX, D
        assert k1.deep_plan(D, "K5")["smem"] == want, D
        assert k1.deep_plan(D, "K1")["resident"] == (D <= 384), D
        assert k7.tile_width(_build.head_instance(D)) == 128 and \
            k7.cross_stages(_build.head_instance(D)) == 8, D
        tile = 64 * 128 * 2
        assert k7._cross_smem(kb, 908, D) == k7._cross_smem(kb, 908, 128) == \
            slack + 8 * tile + 16 * 8 + 4 * (kb * sp + sp) + 2 * kb * (sp + 8) <= _build.SMEM_MAX
        assert k6.sm90_smem(kb, 908, D) == k6.sm90_smem(kb, 908, 128) == \
            slack + 8 * 64 * 128 + 2 * tile + 16 * 8 + 4 * (kb * sp + 3 * sp) + \
            2 * kb * (sp + 8) <= _build.SMEM_MAX
        for plan in (k7.cross_plan(16, 1772, D, fp32=False), k6.plan(16, 1772, D, fp32=False)):
            assert plan == {"beam_tiles": 1, "chunk": 64}, D
        for plan in (k7.cross_plan(5, 908, D, fp32=False), k6.plan(5, 908, D, fp32=False)):
            assert plan == {"beam_tiles": 1, "chunk": 908}, D
        # the FMA route: 16 beams x (64 dims of q + 2 parts x 128 columns + 2) fp32
        fixed = 4 * (16 * 64 + 2 * 16 * 128 + 2 * 16)
        assert k7.fma_cross_chunk(16, 1772, D) == 1772 and \
            fixed + 4 * 16 * 1772 <= _build.SMEM_MAX, D


@pytest.mark.parametrize("kernel", ["K1", "K5", "K4"])
def test_deep_plan_builds_each_score_tile_once_for_several_blocks(kernel):
    """At every head dim 257 to 1280 the deep route's CTA owns up to three
    column blocks (the last group the rest) and builds each (q tile, key
    tile)'s score tile ceil(nch / 3) times, K5 in each of its two passes; K4
    builds S ceil(nch / 3) times for each of its five gradients and dP for
    the four that need it: against nch times each on one block a CTA. So
    the bytes streamed into shared memory drop: at the caption shape (B16
    T=S=908, ~768 / D heads; K4 at the training shape B4 T=S=980) by the
    ratios the plan gives, for K1 1.1 GB against 4.6 at 2 heads of 384 (q
    and pos_q resident too) and 3.2 against 8.8 at 1 head of 768."""
    for D in range(257, 1281, 8):
        nch = -(-D // 128)
        G = -(-nch // 3)
        H = max(1, 768 // D)
        shape = dict(B=4, T=980, S=980) if kernel == "K4" else dict(B=16, T=908, S=908)
        p = k1.deep_plan(D, kernel, H=H, **shape)
        assert p["blocks"] == 3 and p["nch"] == nch and p["last_blocks"] == nch - 3 * (G - 1), D
        assert sum(k1.deep_groups(D)) == nch and len(k1.deep_groups(D)) == G, D
        assert p["smem"] <= _build.SMEM_MAX, D
        if kernel == "K4":
            assert (p["ctas_per_key_tile"], p["ctas_per_q_tile"]) == (3 * G, 2 * G), D
            assert (p["score_builds"], p["dp_builds"]) == (5 * G, 4 * G), D
            assert (p["score_builds_one_block"], p["dp_builds_one_block"]) == (5 * nch, 4 * nch)
        else:
            passes = 2 if kernel == "K5" else 1
            assert p["ctas_per_tile"] == G and p["score_builds"] == passes * G, D
            assert p["score_builds_one_block"] == passes * nch, D
        assert p["bytes"] < p["bytes_one_block"], D  # nch >= 3 past 256
    gb = lambda D, H: (round(k1.deep_plan(D, "K1", H=H)["bytes"] / 1e9, 1),
                       round(k1.deep_plan(D, "K1", H=H)["bytes_one_block"] / 1e9, 1))
    if kernel == "K1":
        assert gb(384, 2) == (1.1, 4.6) and gb(768, 1) == (3.2, 8.8)
