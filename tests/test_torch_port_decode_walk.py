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
from musketeer_tpu_torch.ops import decode_stack as k7
from musketeer_tpu_torch.ops import topk_projection as k2
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


def walk_stack(pack, x0, sbias, cbias, self_k, self_v, cross_k, cross_v, idx, beam_size,
               scaling, cps):
    """K7 as the tensor-core route computes it → (x_out, k_new, v_new)."""
    rows, d = x0.shape
    L, _, H, Tmax, hd = self_k.shape
    B, dt = rows // beam_size, x0.dtype
    s = k7._scalar(scaling, dt)
    rnd = lambda v: v.to(dt)

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
    later = torch.arange(Tmax) > idx
    x = x0
    for l in range(L):
        ln, bm = pack["ln"][l], pack["b_misc"][l]
        qkv = product(ln_rows(x, ln[0], ln[1]), pack["w_self3"][l], pack["b_self3"][l], c_qkv)
        q, kn, vn = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
        k_new[l], v_new[l] = kn, vn
        kc, vc = self_k[l].float(), self_v[l].float()
        kc[:, :, idx] = kn.float().view(rows, H, hd)
        vc[:, :, idx] = vn.float().view(rows, H, hd)
        qf = (q * s).float().view(rows, H, 1, hd)
        w = (qf @ kc.transpose(-1, -2))[:, :, 0] + sbias[l]
        probs = rnd(torch.softmax(w.masked_fill(later, k7.NEG_INF), dim=-1))
        o = rnd((probs.float()[:, :, None, :] @ vc)[:, :, 0])
        x = product(o.reshape(rows, d), pack["w_so"][l], bm[0], c_dd, residual=x)
        q2 = product(ln_rows(x, ln[2], ln[3]), pack["w_cq"][l], bm[1], c_dd, scale=s)
        qb = q2.float().view(B, beam_size, H, hd).transpose(1, 2)
        w2 = qb @ cross_k[l].float().transpose(-1, -2) + cbias[:, :, None, :]
        p2 = rnd(torch.softmax(w2, dim=-1))
        o2 = rnd(p2.float() @ cross_v[l].float())
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
    assert k2.proj_plan(80, 768, 132, 59520) == (80, 132)
    assert k2.proj_plan(80, 1024, 132, 59520) == (48, 132)  # h of 80 rows would not fit
    assert k2.proj_plan(10, 768, 132, 1024) == (16, 8)
