"""The port at head dims past 128, up to 256, against the JAX package, on the CPU.

The attention kernels (K1, K3, K4, K5, K6, K7) are compiled at the tile widths
``_build.HEAD_DIMS``; past 128 a head dim runs on the instances 192 and 256.
There the bf16 tensor-core attention core (K1, K3, K5) and K4 run on the pair
route: the deep route's CTA (a builder warpgroup and one block warpgroup per
column block of 128) with both blocks of the output in one CTA, so that each
score tile (K4: S and dP) is built once, in chunks of 128 columns (the last
one 64-column box up to D 192) whose k-steps run back to back into one fp32
accumulator, in the order of one whole-width product as at the instances up
to 128, and each block's P·v (or gradient) products use that one tile
(``flash_attention_infer.deep_plan``); the FMA kernels take
32-row tiles, K6's and K7's cross-attentions a shallower ring, K7's
self-attention and the fp32 cross-attention their key rows 64 dims at a
time, none of which changes a bf16 sum's order. The kernels run only on the
card; here, on the same seeded numpy inputs:

- (i) the tile walks of K1 and K3/K4 (``test_torch_port_attention_walk.py``,
  ``test_torch_port_attention_bwd_walk.py``) at D 192 (causal) and 256 (rel,
  padded keys), T = S = 70, against the Pallas kernels in interpret mode, in
  bf16, to chip_smoke.py's tolerance (2⁻⁶ of max(1, max|ref|)); K1's walk
  also block by block, the one score tile against each 128 columns of v
  alone, bit-equal to the whole;
- (ii) the K6 and K7 walks at hd 256 against the JAX kernels;
- (iii) ``ofa_tiny`` widened to hd 256 (d 256, 1 head; 2 + 2 layers, ResNet
  (1, 1, 1), 64² images), float32, the JAX tree bridged by ``from_jax``:
  encode and beam search against the JAX flash branch (tokens exactly,
  encoder features and beam scores within 1e-5 of max|ref|), two serving-B
  decode steps, and the joint step's loss and gradients to the bounds of
  ``test_torch_port_head_dim.py``; each JAX program compiled once;
- (iv) with no card: every head dim 1 to 256 on its instance, and the
  shared-memory planners at the serving and training shapes and at
  chip_smoke.py phase 28's score-chunked shape, their bytes against the
  layouts of the CUDA sources; the pair route's plan at every head dim 129
  to 256 (blocks a CTA, score builds per tile, K4's S and dP builds, the
  last chunk's boxes, bytes streamed at the caption and training shapes,
  shared memory), its constants against the CUDA sources.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from tests.test_torch_port_head_dims_any import _bf16_err, _stack_inputs, _tile
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

# (i): one case a head dim: causal at 192, rel with padded keys at 256
WALKS = {192: dict(T=70, S=70, causal=True), 256: dict(T=70, S=70)}
N_SM = 132  # an H100 SXM's SMs: the split-K plans of K7's products


def _walk_inputs(D: int) -> dict:
    """WALKS[D]'s inputs; causal, the first key unpadded, so that no query
    row is fully masked (the JAX training kernel spreads such a row over its
    padded keys: ``test_torch_port_train_kernels.py`` keeps those cases)."""
    x = _inputs(D=D, **WALKS[D])
    if WALKS[D].get("causal"):
        x["kpad"][:, 0] = False
    return x


@pytest.mark.parametrize("D", list(WALKS))
def test_k1_walk_past_128_matches_jax_kernel_and_its_column_halves(D):
    x, causal = _walk_inputs(D), WALKS[D].get("causal", False)
    ref = jax_k1(*_jax_args(x, jnp.bfloat16), causal=causal)
    t = [_tile(a, D) for a in _torch_args(x, torch.bfloat16)]
    out = walk(*t, causal=causal)
    err, lim = _bf16_err(out[..., :D], ref)
    assert out.dtype == torch.bfloat16 and err <= lim, f"D{D}: {err} > {lim}"
    # one CTA owns both column blocks of 128 and builds each score tile once
    # for them: that tile against v's 128 columns of each block alone
    assert _build.col_halves(D) == 2
    plan = k1.deep_plan(D)
    assert (plan["route"], plan["blocks"], plan["ctas_per_tile"], plan["score_builds"]) == \
        ("pair", 2, 1, 1)

    def half(c0):  # v's columns c0 .. c0 + 127 alone (zeros elsewhere)
        v = torch.zeros_like(t[2])
        n = min(128, v.shape[-1] - c0)
        v[..., :n] = t[2][..., c0:c0 + n]
        return walk(*t[:2], v, *t[3:], causal=causal)[..., :n]

    assert torch.equal(torch.cat([half(0), half(128)], -1)[..., :D], out[..., :D])


@pytest.mark.parametrize("D", list(WALKS))
def test_k3_k4_walks_past_128_match_jax_kernels(D):
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
            a = a[..., :D]
        err, lim = _bf16_err(a, b)
        assert err <= lim, f"D{D} {name}: {err} > {lim}"


def test_k6_walk_at_hd256_matches_jax_kernel():
    x = _k6_inputs(B=3, H=2, Kb=5, S=150, D=256, full_pad=2, seed=6)
    args = [torch.from_numpy(x["q"]).to(torch.bfloat16)] + \
        [torch.from_numpy(x[n]) for n in K6_NAMES[1:]]
    out = walk_k6(*args)
    ref = np.asarray(jax_k6(jnp.asarray(x["q"], jnp.bfloat16),
                            *(jnp.asarray(x[n]) for n in K6_NAMES[1:])).astype(jnp.float32))
    live = [b for b in range(ref.shape[0]) if not x["enc_pad"][b].all()]
    err, lim = _bf16_err(out[live], ref[live])
    assert err <= lim, f"{err} > {lim}"
    assert (out[2] == 0).all()  # the fully padded sample (JAX on XLA:CPU gives NaN there)


def test_k7_walk_at_hd256_matches_jax_kernel():
    hd = 256
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
    # d 512, f 1024 at rows 6: the splits an H100's 132 SMs give each product
    rows, d = args[0].shape
    cps = tuple(k7.split_plan(dout, K, rows, N_SM)
                for dout, K in k7._products(d, 2 * d).values())
    out = walk_stack(pack, *args, 3, Kb, scaling, cps)
    for name, a, b in zip(("x_out", "k_new", "v_new"), out, ref):
        err, lim = _bf16_err(a, np.asarray(b.astype(jnp.float32)))
        assert err <= lim, f"hd{hd} {name}: {err} > {lim}"


# ---------------------------------------------------------------------------
# (iii) the model at hd 256
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """ofa_tiny at d 256 in one head of 256: parameters drawn by the port's
    seeded init in the JAX layout, random rel-pos tables and BN statistics;
    each JAX program compiles once."""
    from musketeer_tpu.models import ofa as jofa
    from musketeer_tpu_torch import config as tc
    from musketeer_tpu_torch.params import from_jax, init_ofa_params

    cfg_j = dataclasses.replace(
        jc.ofa_tiny(), embed_dim=256, ffn_dim=1024, attention_heads=1, encoder_layers=2,
        decoder_layers=2, resnet_layers=(1, 1, 1), dtype="float32", use_flash_attention=True)
    assert cfg_j.head_dim == 256
    cfg_t = tc.ModelConfig(**dataclasses.asdict(cfg_j))
    tree = init_ofa_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    params_np = _randomize(jax.tree.map(lambda a: a.numpy(), tree), np.random.RandomState(7))
    src, imgs, masks = (np.array(a) for a in make_batch(cfg_j, B=2, T=8, img=64))
    params_j = jax.tree.map(jnp.asarray, params_np)
    enc_j = jax.jit(jofa.encode, static_argnums=1)(
        params_j, cfg_j, jnp.asarray(src), jnp.asarray(imgs), jnp.asarray(masks))
    return dict(name="hd256", cfg_j=cfg_j, cfg_t=cfg_t, params_np=params_np,
                params_j=params_j, params_t=from_jax(params_np, cfg_t, "cpu", torch.float32),
                src=src, imgs=imgs, masks=masks, enc_j=enc_j)


def test_hd256_encode_and_beam_search_match_jax(pair):
    _encode_and_beam(pair)


def test_hd256_serving_b_decode_steps_match_jax(pair):
    _serving_b(pair)


def test_hd256_joint_step_loss_and_gradients_match_jax(pair):
    _joint_step(pair)


# ---------------------------------------------------------------------------
# (iv) no card
# ---------------------------------------------------------------------------

def test_head_dims_past_128_instances_and_shared_memory_plans():
    """Every head dim 129 to 256 runs on 192 or 256 (K6's rows rounded to 16
    first) in two column blocks, and 257 on the deep route in three column
    blocks; the planners' bytes are the
    layouts' of the CUDA sources at the instances 192 and 256, and each fits
    a block: K1/K3/K5 on the pair route (``DeepFwd<PW, true>``: q's and
    pos_q's 2 chunks each resident, a key ring of 5 chunks, a block ring of
    2 slots of two chunks, two P tiles, the rows, 19 mbarriers), K4
    (``DeepBwd<PW, false>``: a score ring of 4 slots of two chunks, the block
    ring, two P tiles, a rel tile; ``DeepBwd<PW, true>``: two buffers of two
    dW tiles in place of the P tiles and rel), K6 and K7's cross-attention at
    the serving shape (B16 Kb5 S908: whole rows on rings of 5 and 4 tiles)
    and at phase 28's (Kb16 S1772: past the whole row's fit, so the
    score-chunked route)."""
    for D in range(129, 257):
        _build.check_head_dim("k", D)
        dp = 192 if -(-D // 8) * 8 <= 192 else 256
        assert _build.head_instance(D) == dp and _build.col_halves(D) == 2, D
        assert _build.head_instance(D, 16) == (192 if -(-D // 16) * 16 <= 192 else 256), D
    assert [_build.col_halves(D) for D in (1, 64, 128)] == [1, 1, 1]
    _build.check_head_dim("k", 257)
    assert _build.head_instance(257) == _build.DEEP and _build.col_halves(257) == 3
    bars, slack = 8, 1024
    chunk, ptile, rows, rel = 64 * 128 * 2, 64 * 64 * 2, 3 * 64 * 4, 64 * 72 * 2
    fwd = 4 * chunk + 5 * chunk + 2 * 2 * chunk + 2 * ptile + rows + bars * 19 + slack
    kv = 4 * 2 * chunk + 2 * 2 * chunk + 2 * ptile + rel + bars * 16 + slack
    qm = 4 * 2 * chunk + 2 * 2 * chunk + 2 * 2 * ptile + bars * 16 + slack
    bwd = max(kv, qm)
    for dp in (192, 256):
        tile = 64 * dp * 2
        assert k1.sm90_smem(dp) == fwd <= _build.SMEM_MAX, dp
        assert k1.sm90_smem(dp, bwd=True) == bwd <= _build.SMEM_MAX, dp
        assert (k1.deep_plan(dp, "K4")["smem_kv"], k1.deep_plan(dp, "K4")["smem_q"]) == (kv, qm)
        st = {192: 5, 256: 4}[dp]
        assert k7.cross_stages(dp) == st
        sp, kb = 960, 5  # S 908 in 64-key tiles; the serving beams
        assert k7._cross_smem(kb, 908, dp) == \
            slack + st * tile + 16 * st + 4 * (kb * sp + sp) + 2 * kb * (sp + 8) <= _build.SMEM_MAX
        assert k6.sm90_smem(kb, 908, dp) == \
            slack + st * 64 * dp + 2 * tile + 16 * st + 4 * (kb * sp + 3 * sp) + \
            2 * kb * (sp + 8) <= _build.SMEM_MAX
        # the score-chunked route (decode_attn::smem_bytes_chunked and K6's):
        # the ring, K6's two bf16 value tiles, the mbarriers, two P tiles
        # [16][72] bf16, the 8 warps' row maxes and sums [8][16][2] fp32
        chunked = 2 * 2 * 16 * 72 + 4 * 2 * 8 * 16
        assert slack + st * tile + 16 * st + chunked <= _build.SMEM_MAX
        assert slack + st * 64 * dp + 2 * tile + 16 * st + chunked <= _build.SMEM_MAX
        for plan in (k7.cross_plan(16, 1772, dp, fp32=False), k6.plan(16, 1772, dp, fp32=False)):
            assert plan == {"beam_tiles": 1, "chunk": 64}, dp
        for plan in (k7.cross_plan(16, 1772, dp, fp32=True), k6.plan(16, 1772, dp, fp32=True)):
            assert plan["chunk"] == 1772, dp  # the FMA route: the whole row fits
    assert (k1.sm90_smem(192), k1.sm90_smem(256)) == (231320, 231320)
    assert (k1.sm90_smem(192, bwd=True), k1.sm90_smem(256, bwd=True)) == (230528, 230528)
    assert kv == 223360
    # the instances up to 128 keep their layouts
    assert [k7.cross_stages(dp) for dp in (32, 64, 80, 128)] == [8, 8, 8, 8]
    assert k1.sm90_smem(128) == 181304 and k1.sm90_smem(128, bwd=True) == 217656


def test_pair_route_constants_match_the_cuda_sources():
    """The pair route's planner constants as the CUDA sources state them
    (``csrc/flash_fwd_sm90.cuh``): two block warpgroups a CTA (PW), K4's
    score ring of 4 slots, the forward's key ring of 5 chunks, block rings of
    2 slots of PW chunks, q's and pos_q's 2 chunks each resident, and the
    register budget 32 + 224 + 2 x 128 = 4 x 128 of 512 threads; the column
    split that ran head dims 129 to 256 before is gone from both sources
    (``Layout`` and ``BwdLayout`` only up to 128, no column halves)."""
    csrc = Path(k1.__file__).resolve().parent.parent / "csrc"
    fwd_src = (csrc / "flash_fwd_sm90.cuh").read_text()
    bwd_src = (csrc / "flash_bwd_sm90.cuh").read_text()
    grab = lambda pat, src=fwd_src: int(re.search(pat, src, re.S)[1])  # noqa: E731
    assert grab(r"constexpr int PW = (\d+);") == k1.PAIR_BLOCKS == 2
    assert grab(r"using PairScoreRing = Ring<(\d+), 2 \* CHUNK>;") == k1.PAIR_SCORE_STAGES
    assert grab(r"using PairKeyRing = Ring<(\d+), CHUNK>;") == k1.PAIR_KEY_STAGES
    assert grab(r"using PairBlockRing = Ring<(\d+), PW \* CHUNK>;") == k1.PAIR_BLOCK_STAGES
    assert grab(r"struct Cta<PW> \{.*?RESIDENT_NK = (\d+);") == 2
    regs = [grab(rf"PAIR_{n}_REGS = (\d+)") for n in ("LAUNCH", "PRODUCER", "BUILDER")]
    assert regs == [128, 32, 224] and regs[1] + regs[2] + 2 * regs[0] == 4 * regs[0]
    assert 65536 // (128 * (2 + k1.PAIR_BLOCKS)) == regs[0]
    for src in (fwd_src, bwd_src):
        assert not re.search(r"\bNCH\b|\bvboxes\b|\bload_cols\b|\bhalf\b =", src)
    assert "static_assert(DP <= 128" in fwd_src


@pytest.mark.parametrize("kernel", ["K1", "K5", "K4"])
def test_pair_plan_builds_each_score_tile_once_for_both_blocks(kernel):
    """At every head dim 129 to 256 the bf16 CTA owns both column blocks of
    128 (one CTA per q tile; K4 three per key tile, one a gradient, and two
    per q tile) and builds each (q tile, key tile)'s score tile once, K5 in
    each of its two passes; K4 builds S once for each of its five gradients
    and dP for the four that need it: 5 and 4 against the column split's 10
    and 8. The last chunk is one 64-column box up to D 192 (on the padded
    head dim), so the bytes streamed at the caption shape (B16 T=S=908, 4
    heads of 192 or 3 of 256) and the training shape (B4 T=S=980) are the
    same at both, the width being 768 at each."""
    for D in range(129, 257):
        shape = dict(B=4, T=980, S=980) if kernel == "K4" else dict(B=16, T=908, S=908)
        p = k1.deep_plan(D, kernel, H=3, **shape)
        assert (p["route"], p["blocks"], p["last_blocks"], p["nch"]) == ("pair", 2, 2, 2), D
        assert k1.deep_groups(D) == [2] and _build.col_halves(D) == 2, D
        assert p["last_boxes"] == (1 if -(-D // 8) * 8 <= 192 else 2), D
        assert p["smem"] <= _build.SMEM_MAX, D
        if kernel == "K4":
            assert (p["ctas_per_key_tile"], p["ctas_per_q_tile"]) == (3, 2), D
            assert (p["score_builds"], p["dp_builds"]) == (5, 4), D
            assert (p["score_builds_one_block"], p["dp_builds_one_block"]) == (10, 8), D
        else:
            passes = 2 if kernel == "K5" else 1
            assert (p["ctas_per_tile"], p["score_builds"]) == (1, passes), D
            assert p["score_builds_one_block"] == 2 * passes, D
            assert p["resident"], D
        assert p["bytes"] < p["bytes_one_block"], D
    shape = dict(B=4, T=980, S=980) if kernel == "K4" else dict(B=16, T=908, S=908)
    gb = {D: round(k1.deep_plan(D, kernel, H=768 // D, **shape)["bytes"] / 1e9, 3)
          for D in (192, 256)}
    assert gb[192] == gb[256], gb
    want = {"K1": 1.109, "K5": 1.817, "K4": 3.322}[kernel]
    assert gb[256] == want, gb
