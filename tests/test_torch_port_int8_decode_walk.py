"""The bf16 order and rounding of K2-q8's and K6's tensor-core routes, modelled on the CPU.

Both kernels read int8 and widen it exactly to bf16 on the chip, so their
products are bf16 × bf16 with fp32 sums, as the TPU kernels' are:

- K2-q8 (``project_with_stats`` with an int8 ``w``) runs K2's persistent
  kernel (``csrc/topk_projection.cu``): the fp32 dot times the row scale,
  the padded vocabulary −1e9, then K2's epilogue, whose block statistics are
  reduced in a fixed order (``walk_stats``).
- K6 (``decode_cross_attention_int8``, ``csrc/decode_cross_attn.cu``) forms
  w = dot · k_scale + bias in one fused multiply-add (pads: k_scale 0 and
  bias −1e9, so w is −1e9 exactly), clamps the max at −1e8, sums e = exp(w −
  m) per lane over every 32nd key and then by a butterfly (xor 16, 8, 4, 2,
  1), floors the sum at 1e-38, rounds p = e / l · v_scale to bf16, and adds
  the value product's fp32 partials 16 keys (one mma k-step) at a time.

The kernels run only on the card; ``walk_proj_q8`` and ``walk_k6`` restate
that order and rounding in PyTorch, so that the CPU shows the rounding stays
within the tolerance ``chip_smoke.py`` holds the kernels to (phases 10 and
11: 2⁻⁶ of max(1, max|ref|), bmax and Z 1e-5 relative), here against the
JAX package's Pallas kernels run in interpret mode on the same bf16 inputs.
Both kernels permute the depth (K2-q8) or the head dim (K6) inside their
products so that each lane's int8 fragment is one 32-bit word; the index
maps are checked here to be bijections that the other operand follows. The
routing and shared-memory helpers are pure Python and are tested with no GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu.ops.decode_cross_attn import decode_cross_attention_int8 as jax_k6
from musketeer_tpu.ops.topk_projection import project_with_stats as jax_k2
from musketeer_tpu_torch.ops import _build
from musketeer_tpu_torch.ops import decode_cross_attn as k6
from musketeer_tpu_torch.ops import topk_projection as k2
from tests.test_torch_port_decode_walk import walk_cross, walk_stats
from tests.test_torch_port_serving_kernels import K6_NAMES, _k6_inputs, _q8

TOL = 2.0 ** -7 * 2  # chip_smoke.py's BF16_TOL


def walk_proj_q8(h: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, vocab_size: int):
    """K2-q8 as the tensor-core route computes it → (logits, bmax, Z)."""
    x = (h.float() @ w8.float().t()) * scale.float()[None, :]  # int8 widened exactly
    x[:, vocab_size:] = k2.NEG_INF
    return walk_stats(x, h.dtype)


def _lane_sum(e: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis as a warp sums it: lane l over s = l, l + 32, ...
    in order, then the butterfly xor 16, 8, 4, 2, 1 (every lane ends equal)."""
    S = e.shape[-1]
    e = torch.nn.functional.pad(e, (0, -S % 32)).unflatten(-1, (-1, 32))
    acc = torch.zeros_like(e[..., 0, :])
    for i in range(e.shape[-2]):
        acc = acc + e[..., i, :]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def walk_k6(q, k_i8, v_i8, k_scale, v_scale, bias, enc_pad, budget=_build.SMEM_MAX):
    """K6 as the tensor-core route (fp32: the FMA route) computes it → [B, H,
    Kb, D] in q's dtype, on the route ``k6.plan`` picks in ``budget`` bytes
    of shared memory: past 16 beams or the whole row's fit, ``walk_cross``'s
    beam tiles and score chunks with K6's clamp, floor and v_scale."""
    B, H, Kb, D = q.shape
    S = k_i8.shape[2]
    plan = k6.plan(Kb, S, D, q.dtype == torch.float32, budget)
    if plan["beam_tiles"] > 1 or plan["chunk"] < S:
        pad = enc_pad[:, None, :]
        ks = torch.where(pad, 0.0, k_scale.float())
        bi = torch.where(pad, k6.NEG_INF, bias.float())
        # w = dot · k_scale + bias as one product: k_scale folded into the keys
        # (exact: an int8 times an fp32 scale), the fp32 sums in another order
        keys = k_i8.float() * ks[..., None]
        return walk_cross(q.float(), keys, v_i8, bi, plan["chunk"], q.dtype, clamp=-1e8,
                          floor=1e-38, v_scale=v_scale.float())
    dot = q.float() @ k_i8.float().transpose(-1, -2)  # [B, H, Kb, S]: exact products, fp32 sums
    pad = enc_pad[:, None, :]
    ks = torch.where(pad, 0.0, k_scale.float())[:, :, None, :]
    bi = torch.where(pad, k6.NEG_INF, bias.float())[:, :, None, :]
    w = (dot.double() * ks.double() + bi.double()).float()  # one fused multiply-add
    m = w.amax(dim=-1, keepdim=True).clamp_min(-1e8)
    e = torch.exp(w - m)
    l = _lane_sum(e).clamp_min(1e-38)[..., None]
    p = ((e / l) * v_scale.float()[:, :, None, :]).to(q.dtype).float()
    v = v_i8.float()
    out = torch.zeros(p.shape[:-1] + (v.shape[-1],))
    for k0 in range(0, p.shape[-1], 16):  # one mma k-step at a time, in order
        out = out + p[..., k0:k0 + 16] @ v[:, :, k0:k0 + 16]
    return out.to(q.dtype)


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("N,D,Vp,vocab_size", [(80, 256, 1024, 1000), (10, 128, 768, 768),
                                               (5, 64, 59520, 59457), (33, 192, 1280, 1200)])
def test_bf16_projection_q8_walk_matches_jax_kernel(N, D, Vp, vocab_size):
    rng = np.random.RandomState(4)
    h = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(Vp, D) * D ** -0.5).astype(np.float32)
    w[vocab_size:] = 0.0
    w8, scale = _q8(w)
    ref = jax_k2(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w8), jnp.asarray(scale),
                 vocab_size=vocab_size)
    out = walk_proj_q8(_bf16(h), torch.from_numpy(w8), torch.from_numpy(scale), vocab_size)
    la, lb = out[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32))
    assert out[0].dtype == torch.bfloat16 and la.shape == lb.shape
    neg = float(torch.tensor(k2.NEG_INF, dtype=torch.bfloat16))  # -1e9 in bf16
    assert (la[:, vocab_size:] == neg).all() and (lb[:, vocab_size:] == neg).all()
    real = np.abs(lb[:, :vocab_size])
    err = float(np.abs(la[:, :vocab_size] - lb[:, :vocab_size]).max())
    assert err <= TOL * max(1.0, float(real.max())), f"logits: max abs err {err}"
    for name, a, b in zip(("bmax", "Z"), out[1:], ref[1:]):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        rel = float(np.abs(a.numpy() - b).max() / np.abs(b).max())
        assert rel <= 1e-5, f"{name}: rel err {rel}"


K6_CASES = {
    "S37, Kb5, a fully padded sample": dict(Kb=5, S=37, full_pad=2),
    "S37, Kb1": dict(Kb=1, S=37, full_pad=None, seed=1),
    "S150, Kb5, a fully padded sample": dict(Kb=5, S=150, full_pad=0, seed=2),
    "S130, Kb16": dict(B=2, Kb=16, S=130, full_pad=None, seed=3),
    # two beam tiles, the scores in chunks of 64 keys (no whole row in 25 000 bytes)
    "S200, Kb18, H2, tiled": dict(B=2, Kb=18, S=200, full_pad=1, seed=4, budget=25000),
}


def _case(spec: dict):
    """A case's inputs and the walk's budget."""
    spec = dict(spec)
    budget = spec.pop("budget", _build.SMEM_MAX)
    return _k6_inputs(**spec), budget


@pytest.mark.parametrize("case", list(K6_CASES))
def test_bf16_k6_walk_matches_jax_kernel(case):
    spec = K6_CASES[case]
    x, budget = _case(spec)
    args = [_bf16(x["q"])] + [torch.from_numpy(x[n]) for n in K6_NAMES[1:]]
    out = walk_k6(*args, budget=budget)
    ref = np.asarray(jax_k6(jnp.asarray(x["q"], jnp.bfloat16),
                            *(jnp.asarray(x[n]) for n in K6_NAMES[1:])).astype(jnp.float32))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    live = [b for b in range(ref.shape[0]) if not x["enc_pad"][b].all()]
    err = float(np.abs(out[live].float().numpy() - ref[live]).max())
    lim = TOL * max(1.0, float(np.abs(ref[live]).max()))
    assert err <= lim, f"{case}: max abs err {err} > {lim}"
    if spec["full_pad"] is not None:
        # exact zeros from the walk, as the clamped max and the subnormal 1e-38
        # floor give on the card; XLA:CPU flushes the floor and the
        # interpreted JAX kernel gives NaN there (ROADMAP §3)
        assert (out[spec["full_pad"]] == 0).all()


@pytest.mark.parametrize("case", list(K6_CASES))
def test_fp32_k6_walk_is_the_plain_version(case):
    x, budget = _case(K6_CASES[case])
    args = [torch.from_numpy(x[n]) for n in K6_NAMES]
    out, ref = walk_k6(*args, budget=budget), k6.decode_cross_attention_int8_plain(*args)
    assert out.dtype == torch.float32
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, f"{case}: rel err {err}"


def test_int8_fragment_permutations_are_consistent():
    """The depth (K2-q8, 128 a stage) and head-dim (K6, 64) permutations: lane
    quad t's fragment in k-step j holds k-slots 2t, 2t+1, 2t+8, 2t+9, taken
    from its int8 word, bytes 4j .. 4j + 3 of its 32 (K2-q8) or 16 (K6)
    bytes. Each map is a bijection, and the 32-bit word form that
    permute_x_i8 applies to X (word 8j + 4hh + t of a group is X's word
    16t + 2j + hh) and that K6 loads q in is the same map."""
    for depth in (128, 64):
        span = depth // 4  # the bytes a lane quad owns per row
        phys = {}
        for j in range(depth // 16):
            for s in range(16):
                t, e = (s % 8) // 2, s % 2 + 2 * (s // 8)
                phys[16 * j + s] = span * t + 4 * j + e
        assert sorted(phys.values()) == list(range(depth))
        for j in range(depth // 16):
            for hh in range(2):
                for t in range(4):
                    logical = 2 * (8 * j + 4 * hh + t)  # the word's low element
                    assert phys[logical] == 2 * (span // 2 * t + 2 * j + hh)
                    assert phys[logical + 1] == phys[logical] + 1


def test_q8_route_picks_plain_fma_or_tensor_cores():
    cuda = torch.device("cuda")  # the helpers read only the device's type: no card needed
    h = torch.empty(80, 768, dtype=torch.bfloat16)
    w8 = torch.empty(1024, 768, dtype=torch.int8)
    assert k2._route(torch.device("cpu"), h, w8) == "plain"
    assert k2._route(cuda, h, w8) == "sm90"
    assert k2._route(cuda, h.float(), w8) == "fma"
    buf = torch.empty(1024 * 768 + 64, dtype=torch.int8)
    base = -buf.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):  # the base off by one byte
        k2._route(cuda, h, buf[base + 1:base + 1 + 1024 * 768].view(1024, 768))
    with pytest.raises(ValueError, match="16-byte"):  # rows of 24 bytes
        k2._route(cuda, h[:, :24], buf[base:base + 1024 * 24].view(1024, 24))


def test_k6_route_picks_plain_fma_or_tensor_cores():
    cuda = torch.device("cuda")
    q = torch.empty(16, 12, 5, 64, dtype=torch.bfloat16)
    kv = torch.empty(16, 12, 908, 64, dtype=torch.int8)
    assert k6._route(torch.device("cpu"), q, kv, kv) == "plain"
    assert k6._route(cuda, q, kv, kv) == "sm90"
    assert k6._route(cuda, q.float(), kv, kv) == "fma"
    with pytest.raises(TypeError, match="dtype"):
        k6._route(cuda, q.half(), kv, kv)
    buf = torch.empty(kv.numel() + 64, dtype=torch.int8)
    base = -buf.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):  # a cache off by 8 bytes
        k6._route(cuda, q, kv, buf[base + 8:base + 8 + kv.numel()].view(kv.shape))


def test_q8_plan_and_shared_memory():
    # a depth of whole 128-deep stages stages as many h chunks as bf16 K2
    assert k2._proj_smem(80, 768, q8=True) == k2._proj_smem(80, 768) <= _build.SMEM_MAX
    # a depth of 64 past the last whole stage: one more zeroed chunk of N rows
    assert k2._proj_smem(16, 64, q8=True) - k2._proj_smem(16, 64) == 16 * 128
    assert k2.proj_plan(80, 768, 132, 59520, q8=True) == (80, 132, False)
    assert k2.proj_plan(80, 1024, 132, 59520, q8=True) == (48, 132, False)  # h of 80 rows would not fit
    assert k2.proj_plan(10, 256, 132, 1024, q8=True) == (16, 8, False)


def test_k6_shared_memory_leaves_two_ctas_an_sm():
    per_sm = 233472  # an SM's shared memory; each CTA also reserves 1 KB
    assert 2 * (k6.sm90_smem(5, 908) + 1024) <= per_sm  # serving A: 192 CTAs in one wave
    assert k6.sm90_smem(k6.BEAM_TILE, 908) <= _build.SMEM_MAX
    # past the whole row's fit the scores run in chunks of the 64-key tiles
    assert k6.sm90_smem(k6.BEAM_TILE, 4096) > _build.SMEM_MAX
    assert k6.plan(k6.BEAM_TILE, 4096, 64, fp32=False) == {"beam_tiles": 1, "chunk": 64}
