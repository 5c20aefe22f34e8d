"""The bf16 order and rounding of K7's and K2's tensor-core routes, modelled on the CPU.

``csrc/skinny_gemm_sm90.cuh`` runs every product of K7 (``decode_stack_step``)
and K2 (``project_with_stats``) in bf16 as W·Xᵀ on wgmma with fp32 sums:

- K7's products split the depth into runs of 64-deep chunks (``cps`` chunks a
  split, the last split shorter where the chunks do not divide evenly); each
  split's fp32 partial is added to the others in split order, and the sum is
  rounded once to bf16 before the epilogue's bias, scaling, gelu and residual,
  each rounded again. A LayerNorm before a product normalises the staged X
  with one-pass fp32 row statistics (the sum and the sum of squares of the
  bf16 row, var = E[x²] − mean², as the product that wrote X hands them on)
  and rounds its output to bf16. The attention
  steps keep the plain version's numerics (probabilities rounded to bf16
  before each value product).
- K2 reduces each 128-token block's max and sum of exp in a fixed order: the
  thread's four values of a row (two m64 halves × two accumulator rows), the
  8 lanes of its quad column by a butterfly (xor 4, 8, 16), then the 4 warps
  as (w0 + w1) + (w2 + w3).

The kernels run only on the card; ``walk_stack`` and ``walk_proj`` restate
that order and rounding in PyTorch, so that the CPU shows the rounding stays
within the tolerance ``chip_smoke.py`` holds the kernels to (phases 4 and 12:
2⁻⁶ of max(1, max|ref|)), here against the JAX package's Pallas kernels run in
interpret mode on the same bf16 inputs. In fp32 the K7 walk is the port's
plain version, to 1e-5. The routing helper that picks the plain, FMA or
tensor-core version is pure Python and is tested here with no GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu.ops.decode_stack import decode_stack_step as jax_k7
from musketeer_tpu.ops.decode_stack import pack_decoder_weights as jax_pack
from musketeer_tpu.ops.decode_stack import transpose_cross_kv
from musketeer_tpu.ops.topk_projection import project_with_stats as jax_k2
from musketeer_tpu_torch.ops import _build
from musketeer_tpu_torch.ops import decode_cross_attn as k6
from musketeer_tpu_torch.ops import decode_stack as k7
from musketeer_tpu_torch.ops import topk_projection as k2
from tests.test_torch_port_serving_kernels import make_stack_inputs
from tests.test_torch_port_serving_kernels import stack_inputs  # noqa: F401  (fixture)

TOL = 2.0 ** -7 * 2  # chip_smoke.py's BF16_TOL
NAMES = ("x0", "sbias", "cbias", "self_k", "self_v", "cross_k", "cross_v")
OUTS = ("x_out", "k_new", "v_new")


def split_dot(a: torch.Tensor, w: torch.Tensor, cps: int) -> torch.Tensor:
    """a·wᵀ as the core sums it: fp32 partials over runs of ``cps`` 64-deep
    chunks, added in split order → fp32 [rows, dout]."""
    K, span = a.shape[1], 64 * cps
    total = None
    for k0 in range(0, K, span):
        p = a[:, k0:k0 + span].float() @ w[:, k0:k0 + span].float().t()
        total = p if total is None else total + p
    return total


def ln_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The LayerNorm applied to the staged X: one-pass fp32 statistics,
    var = E[x²] − mean² (floored at 0), eps 1e-5, the output rounded to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return ((xf - mean) * torch.rsqrt(var + 1e-5) * g + b).to(x.dtype)


def walk_cross(q, k, v, bias, chunk: int, dt, clamp=None, floor=None, v_scale=None):
    """The beam-shared cross-attention of K7 and K6 as their routes compute it:
    q [B, H, Kb, D] fp32, k and v [B, H, S, D], bias [B, H, S] (the pads folded
    in) → [B, H, Kb, D] in ``dt``. The beams run in tiles of 16. Where
    ``chunk`` covers S, the whole row: an exact softmax; else the scores in
    chunks of ``chunk`` keys: a first pass keeps each row's max and sum of
    exp, rescaled as the max moves, a second forms each chunk's
    probabilities. p = exp(w − m) / l (times ``v_scale``: K6) is rounded to
    ``dt``; the value product sums the chunks in order. K6's numerics:
    ``clamp`` the least max, ``floor`` the least sum."""
    B, H, Kb, D = q.shape
    S = k.shape[2]
    step = chunk if chunk < S else S
    out = torch.zeros(B, H, Kb, v.shape[-1])
    for j0 in range(0, Kb, k7.BEAM_TILE):
        w = q[:, :, j0:j0 + k7.BEAM_TILE] @ k.float().transpose(-1, -2) + bias[:, :, None, :]
        m = torch.full(w.shape[:-1], -torch.inf if clamp is None else clamp)
        l = torch.zeros(w.shape[:-1])
        for c0 in range(0, S, step):
            wc = w[..., c0:c0 + step]
            mn = torch.maximum(m, wc.amax(-1))
            l = l * torch.exp(m - mn) + torch.exp(wc - mn[..., None]).sum(-1)
            m = mn
        if floor is not None:
            l = l.clamp_min(floor)
        p = torch.exp(w - m[..., None]) / l[..., None]
        if v_scale is not None:
            p = p * v_scale[:, :, None, :]
        p = p.to(dt).float()
        o = torch.zeros(out[:, :, j0:j0 + k7.BEAM_TILE].shape)
        for c0 in range(0, S, step):
            o = o + p[..., c0:c0 + step] @ v[:, :, c0:c0 + step].float()
        out[:, :, j0:j0 + k7.BEAM_TILE] = o
    return out.to(dt)


def walk_self(q, kc, vc, sb, idx: int, chunk: int, dt):
    """K7's self-attention of one step as its routes compute it: q [rows, H, hd]
    fp32 (scaled), the cache kc, vc [rows, H, Tmax, hd] fp32 with the step's
    K/V at idx, sb [rows, H, Tmax]; the positions after idx masked. The
    scores' max and sum of exp over positions 0..idx, then the probabilities
    rounded to ``dt`` and the values summed in position order, ``chunk``
    positions at a time (the shared memory of a warp)."""
    w = (q[:, :, None, :] @ kc[:, :, :idx + 1].transpose(-1, -2))[:, :, 0] + sb[:, :, :idx + 1]
    m = w.amax(-1, keepdim=True)
    l = torch.exp(w - m).sum(-1, keepdim=True)
    o = torch.zeros(q.shape)
    for c0 in range(0, idx + 1, chunk):
        p = (torch.exp(w[..., c0:c0 + chunk] - m) / l).to(dt).float()
        o = o + (p[:, :, None, :] @ vc[:, :, c0:c0 + p.shape[-1]])[:, :, 0]
    return o.to(dt)


def walk_stack(pack, x0, sbias, cbias, self_k, self_v, cross_k, cross_v, idx, beam_size,
               scaling, cps, budget=_build.SMEM_MAX, sa_chunk=k7.SA_CHUNK):
    """K7 as the tensor-core route (fp32: the FMA route) computes it → (x_out,
    k_new, v_new); the cross-attention's route as ``k7.stack_plan`` picks it
    in ``budget`` bytes of shared memory, the self-attention's probabilities
    ``sa_chunk`` positions at a time. A width d that is not a multiple of 64
    has a short last 64-deep chunk (zeros past d, as TMA fills them)."""
    rows, d = x0.shape
    L, _, H, Tmax, hd = self_k.shape
    B, dt = rows // beam_size, x0.dtype
    s = k7._scalar(scaling, dt)
    rnd = lambda v: v.to(dt)
    S = cross_k.shape[3]
    chunk = k7.stack_plan(beam_size, S, Tmax, idx, d, H, dt == torch.float32, budget)["chunk"]

    def product(a, w, bias, k_cps, scale=None, gelu=False, residual=None):
        v = rnd(split_dot(a, w, k_cps))
        v = rnd(v + bias)
        if scale is not None:
            v = v * scale  # a bf16 product: rounded
        if gelu:
            v = k7._gelu_exact(v)
        return v if residual is None else residual + v

    c_qkv, c_dd, c_fc1, c_fc2 = cps
    k_new = torch.empty((L, rows, d), dtype=dt)
    v_new = torch.empty_like(k_new)
    x = x0
    for l in range(L):
        ln, bm = pack["ln"][l], pack["b_misc"][l]
        qkv = product(ln_rows(x, ln[0], ln[1]), pack["w_self3"][l], pack["b_self3"][l], c_qkv)
        q, kn, vn = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
        k_new[l], v_new[l] = kn, vn
        kc, vc = self_k[l].float(), self_v[l].float()
        kc[:, :, idx] = kn.float().view(rows, H, hd)
        vc[:, :, idx] = vn.float().view(rows, H, hd)
        o = walk_self((q * s).float().view(rows, H, hd), kc, vc, sbias[l], idx, sa_chunk, dt)
        x = product(o.reshape(rows, d), pack["w_so"][l], bm[0], c_dd, residual=x)
        q2 = product(ln_rows(x, ln[2], ln[3]), pack["w_cq"][l], bm[1], c_dd, scale=s)
        qb = q2.float().view(B, beam_size, H, hd).transpose(1, 2)
        o2 = walk_cross(qb, cross_k[l], cross_v[l], cbias, chunk, dt)
        x = product(o2.transpose(1, 2).reshape(rows, d), pack["w_co"][l], bm[2], c_dd, residual=x)
        h1 = product(ln_rows(x, ln[4], ln[5]), pack["w_fc1"][l], pack["b_fc1"][l], c_fc1,
                     gelu=True)
        x = product(h1, pack["w_fc2"][l], bm[3], c_fc2, residual=x)
    return x, k_new, v_new


def _port_args(s, dtype):
    pack = k7.pack_decoder_weights(s["port_layers"], dtype)
    x = {n: torch.from_numpy(s["x"][n]) for n in NAMES}
    for n in ("x0", "self_k", "self_v", "cross_k", "cross_v"):
        x[n] = x[n].to(dtype)
    return pack, [x[n] for n in NAMES]


# chunks per split of the q|k|v, d x d, fc1 and fc2 products at d 256 (4
# chunks) and f 512 (8 chunks): one chunk a split, and 3 (4 = 3 + 1, 8 = 3 + 3 + 2)
SPLITS = {"cps1": (1, 1, 1, 1), "cps3": (3, 3, 3, 3), "mixed": (2, 3, 4, 3)}


@pytest.fixture(scope="module")
def jax_bf16(stack_inputs):  # noqa: F811
    """The Pallas K7 in interpret mode on the fixture's inputs in bf16."""
    s = stack_inputs
    x = s["x"]
    bf = lambda n: jnp.asarray(x[n], jnp.bfloat16)
    kt, vt = transpose_cross_kv(bf("cross_k"), bf("cross_v"))
    pack = jax_pack(jax.tree.map(jnp.asarray, s["layers"]), jnp.bfloat16)
    return {idx: jax_k7(pack, bf("x0"), jnp.asarray(x["sbias"]), jnp.asarray(x["cbias"]),
                        bf("self_k"), bf("self_v"), kt, vt, jnp.int32(idx), beam_size=s["Kb"],
                        scaling=s["scaling"])
            for idx in (0, 5)}


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("cache_index", [0, 5])
def test_bf16_stack_walk_matches_jax_kernel(stack_inputs, jax_bf16, cache_index, split):  # noqa: F811
    s = stack_inputs
    pack, args = _port_args(s, torch.bfloat16)
    out = walk_stack(pack, *args, cache_index, s["Kb"], s["scaling"], SPLITS[split])
    for name, a, b in zip(OUTS, out, jax_bf16[cache_index]):
        b = np.asarray(b.astype(jnp.float32))
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape, name
        err = float(np.abs(a.float().numpy() - b).max())
        lim = TOL * max(1.0, float(np.abs(b).max()))
        assert err <= lim, f"{name} cache_index {cache_index} {split}: max abs err {err} > {lim}"


@pytest.mark.parametrize("split", ["cps1", "cps3"])
@pytest.mark.parametrize("cache_index", [0, 2, 5])
def test_fp32_stack_walk_is_the_plain_version(stack_inputs, cache_index, split):  # noqa: F811
    s = stack_inputs
    pack, args = _port_args(s, torch.float32)
    out = walk_stack(pack, *args, cache_index, s["Kb"], s["scaling"], SPLITS[split])
    ref = k7.decode_stack_plain(pack, *args, cache_index, s["Kb"], s["scaling"])
    for name, a, b in zip(OUTS, out, ref):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-5, f"{name} cache_index {cache_index} {split}: rel err {err}"


# past today's routes at a small size: 18 beams (two beam tiles), S 200 in
# score chunks of 64 keys (a 25 000-byte budget holds no whole row), the
# self-attention over Tmax 40 in chunks of 16 positions, d 96 = 64 + 32 (3
# heads of 32: a short last chunk in every product)
TILED = dict(L=2, B=2, Kb=18, H=3, hd=32, f=384, Tmax=40, S=200)
TILED_BUDGET, TILED_SA_CHUNK, TILED_CPS = 25000, 16, (1, 2, 1, 4)


@pytest.fixture(scope="module")
def tiled_inputs():
    return make_stack_inputs(**TILED, seed=5)


@pytest.fixture(scope="module")
def jax_tiled(tiled_inputs):
    """The Pallas K7 in interpret mode on the tiled shape's inputs in bf16."""
    s, x = tiled_inputs, tiled_inputs["x"]
    bf = lambda n: jnp.asarray(x[n], jnp.bfloat16)
    kt, vt = transpose_cross_kv(bf("cross_k"), bf("cross_v"))
    pack = jax_pack(jax.tree.map(jnp.asarray, s["layers"]), jnp.bfloat16)
    return {idx: jax_k7(pack, bf("x0"), jnp.asarray(x["sbias"]), jnp.asarray(x["cbias"]),
                        bf("self_k"), bf("self_v"), kt, vt, jnp.int32(idx), beam_size=s["Kb"],
                        scaling=s["scaling"])
            for idx in (5, 39)}


def test_tiled_shape_takes_the_new_routes():
    """The tiled shape's plan in its budget: beam tiles, score chunks, cache
    chunks from position 16, a ragged width; in the card's budget the whole
    row of the bf16 route still fits (so only the budget moves it)."""
    d, S, Kb = TILED["H"] * TILED["hd"], TILED["S"], TILED["Kb"]
    for fp32 in (False, True):
        plan = k7.stack_plan(Kb, S, TILED["Tmax"], 39, d, TILED["H"], fp32, TILED_BUDGET,
                             TILED_SA_CHUNK)
        assert plan == dict(beam_tiles=2, chunk=64, cache_chunked=True, ragged=True)
        assert not k7.stack_plan(Kb, S, TILED["Tmax"], 39, d, TILED["H"], fp32)["cache_chunked"]
        assert k7.cross_plan(Kb, S, TILED["hd"], fp32)["chunk"] == S


@pytest.mark.parametrize("cache_index", [5, 39])
def test_bf16_tiled_stack_walk_matches_jax_kernel(tiled_inputs, jax_tiled, cache_index):
    s = tiled_inputs
    pack, args = _port_args(s, torch.bfloat16)
    out = walk_stack(pack, *args, cache_index, s["Kb"], s["scaling"], TILED_CPS, TILED_BUDGET,
                     TILED_SA_CHUNK)
    for name, a, b in zip(OUTS, out, jax_tiled[cache_index]):
        b = np.asarray(b.astype(jnp.float32))
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape, name
        err = float(np.abs(a.float().numpy() - b).max())
        lim = TOL * max(1.0, float(np.abs(b).max()))
        assert err <= lim, f"{name} cache_index {cache_index}: max abs err {err} > {lim}"


@pytest.mark.parametrize("cache_index", [5, 39])
def test_fp32_tiled_stack_walk_is_the_plain_version(tiled_inputs, cache_index):
    s = tiled_inputs
    pack, args = _port_args(s, torch.float32)
    out = walk_stack(pack, *args, cache_index, s["Kb"], s["scaling"], TILED_CPS, TILED_BUDGET,
                     TILED_SA_CHUNK)
    ref = k7.decode_stack_plain(pack, *args, cache_index, s["Kb"], s["scaling"])
    for name, a, b in zip(OUTS, out, ref):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-5, f"{name} cache_index {cache_index}: rel err {err}"


def walk_proj(h: torch.Tensor, w: torch.Tensor, vocab_size: int):
    """K2 as the tensor-core route computes it → (logits, bmax, Z)."""
    x = h.float() @ w.float().t()
    x[:, vocab_size:] = k2.NEG_INF
    return walk_stats(x, h.dtype)


def walk_stats(x: torch.Tensor, dtype: torch.dtype):
    """The tensor-core route's epilogue on the masked fp32 logits x [N, Vp]:
    the logits rounded to ``dtype``, each block's max and sum of exp in the
    kernel's order → (logits, bmax, Z)."""
    N, Vp = x.shape
    nblk = Vp // k2.BLK
    # block position v = 64 half + 16 warp + 8 hh + g -> [N, nblk, warp, g, half, hh]
    t = x.view(N, nblk, 2, 4, 2, 8).permute(0, 1, 3, 5, 2, 4)
    bmax = t.amax(dim=(2, 3, 4, 5))
    e = torch.exp(t - bmax[:, :, None, None, None, None])
    p = ((e[..., 0, 0] + e[..., 0, 1]) + e[..., 1, 0]) + e[..., 1, 1]  # [N, nblk, warp, g]
    p = p[..., 0::2] + p[..., 1::2]  # lanes xor 4
    p = p[..., 0::2] + p[..., 1::2]  # xor 8
    p = p[..., 0] + p[..., 1]  # xor 16 -> [N, nblk, warp]
    bsum = (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])
    return x.to(dtype), bmax, k2._logsumexp_from_blocks(bmax, bsum)


@pytest.mark.parametrize("N,D,Vp,vocab_size", [(80, 256, 1024, 1000), (10, 128, 768, 768),
                                               (5, 64, 59520, 59457)])
def test_bf16_projection_walk_matches_jax_kernel(N, D, Vp, vocab_size):
    rng = np.random.RandomState(3)
    h = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(Vp, D) * D ** -0.5).astype(np.float32)
    w[vocab_size:] = 0.0
    ref = jax_k2(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), vocab_size=vocab_size)
    out = walk_proj(torch.from_numpy(h).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16),
                    vocab_size)
    la, lb = out[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32))
    assert out[0].dtype == torch.bfloat16 and la.shape == lb.shape
    neg = float(torch.tensor(k2.NEG_INF, dtype=torch.bfloat16))  # -1e9 in bf16
    assert (la[:, vocab_size:] == neg).all() and (lb[:, vocab_size:] == neg).all()
    # element by element within one bf16 step of the larger magnitude, plus
    # 1e-6 of max|ref| for the fp32 sums' order (near-zero logits cancel)
    top = np.maximum(np.abs(la), np.abs(lb))
    step = np.exp2(np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    real = np.abs(lb[:, :vocab_size])
    lim = step + 1e-6 * real.max()
    assert (np.abs(la - lb) <= lim).all(), f"logits: {np.abs(la - lb).max()}"
    for name, a, b in zip(("bmax", "Z"), out[1:], ref[1:]):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        err = float(np.abs(a.numpy() - b).max() / np.abs(b).max())
        assert err <= 1e-5, f"{name}: rel err {err}"


def test_route_picks_plain_fma_or_tensor_cores():
    cuda = torch.device("cuda")  # the helper reads only the device's type: no card needed
    w = torch.empty(64, 128, dtype=torch.bfloat16)
    assert _build.route("k", torch.device("cpu"), torch.bfloat16, {"w": w}) == "plain"
    assert _build.route("k", cuda, torch.float32, {"w": w.float()}) == "fma"
    assert _build.route("k", cuda, torch.bfloat16, {"w": w}) == "sm90"
    with pytest.raises(TypeError, match="dtype"):
        _build.route("k", cuda, torch.float16, {"w": w.half()})
    with pytest.raises(ValueError, match="unsupported device"):
        _build.route("k", torch.device("meta"), torch.bfloat16, {"w": w})


def test_route_raises_on_unaligned_bf16():
    cuda = torch.device("cuda")
    buf = torch.empty(4096, dtype=torch.bfloat16)
    base = (-buf.data_ptr() // 2) % 8  # the first element on a 16-byte boundary
    aligned = buf[base:base + 1024].view(16, 64)
    assert _build.route("k", cuda, torch.bfloat16, {"x": aligned}) == "sm90"
    with pytest.raises(ValueError, match="16-byte"):  # the base off by one element
        _build.route("k", cuda, torch.bfloat16, {"x": buf[base + 1:base + 1025].view(16, 64)})
    with pytest.raises(ValueError, match="16-byte"):  # rows of 36 bytes
        _build.route("k", cuda, torch.bfloat16, {"x": buf[base:base + 18 * 16].view(16, 18)})


def test_split_and_row_tile_plans():
    assert [_build.row_tile(r) for r in (1, 16, 17, 33, 48, 49, 80, 81, 500)] == \
        [16, 16, 32, 48, 48, 80, 80, 80, 80]
    # the caption decode shape on 132 SMs: at most one CTA an SM, MAX_SPLITS splits
    for (dout, K), cps in zip(k7._products(768, 3072).values(), (4, 3, 6, 12)):
        assert k7.split_plan(dout, K, 80, 132) == cps
        splits = -(-(-(-K // 64)) // cps)
        assert splits <= k7.MAX_SPLITS and -(-dout // 64) * splits <= 132
    # few output tiles and a deep K: at most MAX_CPS chunks a split, so more
    # than MAX_SPLITS splits (100 chunks: 7)
    assert k7.split_plan(64, 64 * 100, 80, 1) == k7.MAX_CPS
    assert -(-100 // k7.MAX_CPS) == 7 > k7.MAX_SPLITS
    assert k2.proj_plan(80, 768, 132, 59520) == (80, 132, False)
    assert k2.proj_plan(80, 1024, 132, 59520) == (48, 132, False)  # h of 80 rows would not fit
    assert k2.proj_plan(10, 768, 132, 1024) == (16, 8, False)


def test_plans_take_every_phase27_shape():
    """Every shape of chip_smoke.py's phase 27 (a) gets a route, none raises;
    the bf16 cross-attention past the whole row's fit takes 64-key chunks, the
    FMA route past its own fit its largest chunk; today's main shapes (phases
    4, 10, 11 and 12) keep the routes they have."""
    import chip_smoke as cs

    for B, Kb, S, D in cs.SHAPES_CROSS + cs.SHAPES_K6_LONG + cs.SHAPES_K7_LONG:
        for fp32 in (False, True):
            for plan, smem in ((k7.cross_plan(Kb, S, D, fp32), k7._cross_smem),
                               (k6.plan(Kb, S, D, fp32), k6.sm90_smem)):
                assert plan["beam_tiles"] == -(-Kb // 16)
                if fp32:
                    assert plan["chunk"] == k7.fma_cross_chunk(Kb, S, D)
                else:
                    fits = smem(Kb, S, D) <= _build.SMEM_MAX
                    assert plan["chunk"] == (S if fits else 64)
    for Tmax in cs.SHAPES_TMAX:
        for idx in (0, 2047, 2048, Tmax - 1):
            plan = k7.stack_plan(cs.BEAM, 908, Tmax, idx, 768, 12, False)
            assert plan["cache_chunked"] == (idx >= k7.SA_CHUNK)
    for H, hd in cs.SHAPES_WIDTHS:
        assert k7.stack_plan(cs.BEAM, 908, 17, 16, H * hd, H, False)["ragged"]
    for D in cs.SHAPES_K2_D:
        for q8 in (False, True):
            assert k2.proj_plan(80, D, 132, 59520, q8) == (80, 132, True)
    # the widest D whose h rows still fit at some row tile keeps h whole
    assert k2.proj_plan(80, 4992, 132, 59520) == (16, 132, False)
    assert k2.proj_plan(80, 5056, 132, 59520) == (80, 132, True)
    # today's shapes: K6 B16 H12 Kb5 S908, K7 rows 80 S908 Tmax 17, K2 N80 D768
    for fp32 in (False, True):
        assert k6.plan(5, 908, 64, fp32) == {"beam_tiles": 1, "chunk": 908}
        assert k7.stack_plan(5, 908, 17, 16, 768, 12, fp32) == dict(
            beam_tiles=1, chunk=908, cache_chunked=False, ragged=False)
    for q8 in (False, True):
        assert k2.proj_plan(80, 768, 132, 59520, q8) == (80, 132, False)
