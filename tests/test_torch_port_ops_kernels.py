"""K5 and K8 of the PyTorch port against the JAX package's Pallas kernels.

K5 is the JAX package's public attention API (``musketeer_tpu.ops``:
``flash_attention_bias``, ``flash_cross_attention``, ``attention_reference``),
K8 its fused ResNet bottleneck (``ops/bottleneck.py::fused_bottleneck``). On the
CPU the port's wrappers run their plain PyTorch versions; the JAX kernels run
in interpret mode, as the JAX package's own tests run them. Both sides get the
same numpy inputs, made from a seed. Tolerances:

- float32: 1e-5 of max(1, max|ref|) (the two sides sum in different orders);
- K5 in bf16: one bf16 step at max|ref| (2⁻⁷ of its power of two): both sides
  round the probabilities and the output to bf16 after fp32 sums that may
  differ in their last bits, which moves a rounding by at most one step;
- K8 in bf16: 2⁻⁶·max|ref| (five bf16 roundings chained, each of which may
  land one step apart);
- ``attention_reference``: 1e-6 (same arithmetic, fp32);
- K8's gradients: 1e-5 of each leaf's max|g| (both sides differentiate the
  unfused block in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import musketeer_tpu.ops as jax_ops
from musketeer_tpu.ops.bottleneck import fused_bottleneck as jax_k8
from musketeer_tpu_torch import ops
from musketeer_tpu_torch.ops import bottleneck as k8
from musketeer_tpu_torch.ops import flash_attention as k5
from musketeer_tpu_torch.params import block_from_jax

F32_TOL = 1e-5

K5_CASES = {
    # S = 70 pads to Sp = 128; sample 1 has every key masked
    "bias": dict(S=70),
    "bias_causal": dict(S=70, causal=True),
    # block_q = 64: Sp = 64, not the default's 128
    "bias_block_q_64": dict(S=40, block_q=64),
    "bias_bf16": dict(S=70, dtype="bfloat16"),
    "bias_causal_bf16": dict(S=70, causal=True, dtype="bfloat16"),
    # rel in fp32 with bf16 streams: read in its own dtype, not cast to bf16
    "bias_bf16_rel_f32": dict(S=70, dtype="bfloat16", rel_dtype="float32"),
    "cross": dict(S=70, T=37),
    "cross_bf16": dict(S=70, T=37, dtype="bfloat16"),
}


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _bf16_step(ref) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(np.asarray(ref, np.float32)).max())) - 7)


def _k5_inputs(S, T=None, seed=0, B=2, H=2, D=64, masked_sample=1):
    rng = np.random.RandomState(seed)
    T = S if T is None else T
    arr = lambda *shape: (rng.randn(*shape) * 0.5).astype(np.float32)
    x = dict(q=arr(B, H, T, D), k=arr(B, H, S, D), v=arr(B, H, S, D), pos_q=arr(B, H, T, D),
             pos_k=arr(B, H, S, D), rel=arr(H, T, S) * 2)
    kpad = rng.rand(B, S) < 0.2
    kpad[masked_sample] = True
    x["kpad"] = kpad
    return x


def _to_jax(a, dtype):
    return jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, jnp.dtype(dtype))


def _to_torch(a, dtype):
    t = torch.from_numpy(a)
    return t if a.dtype == bool else t.to(getattr(torch, dtype))


@pytest.mark.parametrize("case", list(K5_CASES))
def test_k5_plain_matches_jax_kernel(case):
    spec = dict(K5_CASES[case])
    dtype = spec.pop("dtype", "float32")
    rel_dtype = spec.pop("rel_dtype", dtype)
    causal = spec.pop("causal", False)
    block_q = spec.pop("block_q", 128)
    x = _k5_inputs(**spec)
    cross = "T" in spec
    names = ("q", "k", "v", "pos_q", "pos_k") + (() if cross else ("rel",)) + ("kpad",)
    dt = {n: rel_dtype if n == "rel" else dtype for n in names}
    jx = [_to_jax(x[n], dt[n]) for n in names]
    tx = [_to_torch(x[n], dt[n]) for n in names]
    if cross:
        ref = jax_ops.flash_cross_attention(*jx, block_q=block_q)
        out = ops.flash_cross_attention(*tx, block_q=block_q)
    else:
        ref = jax_ops.flash_attention_bias(*jx, causal=causal, block_q=block_q)
        out = ops.flash_attention_bias(*tx, causal=causal, block_q=block_q)
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == ref.shape
    ref32 = np.asarray(ref, np.float32)
    tol = F32_TOL * max(1.0, np.abs(ref32).max()) if dtype == "float32" else _bf16_step(ref32)
    assert _err(out.float().numpy(), ref32) <= tol, f"{case}: max abs err {_err(out.float(), ref32)}"
    if dtype == "float32":
        # every key of sample 1 masked: the wrapper's Sp - S padded keys count too
        S, mult = x["k"].shape[2], 128 if cross else block_q
        Sp = -(-S // mult) * mult
        mean_v = x["v"][1].sum(axis=1) / Sp  # [H, D]
        np.testing.assert_allclose(out[1].numpy(), np.broadcast_to(mean_v[:, None], out.shape[1:]),
                                   atol=1e-5)


def test_k5_rel_f32_differs_from_rel_cast_to_bf16():
    """rel is read in its own dtype: casting an fp32 rel to bf16 first changes the result."""
    x = _k5_inputs(S=70)
    names = ("q", "k", "v", "pos_q", "pos_k")
    t = [_to_torch(x[n], "bfloat16") for n in names]
    kpad = torch.from_numpy(x["kpad"])
    rel = torch.from_numpy(x["rel"]) * 10
    a = ops.flash_attention_bias(*t, rel, kpad)
    b = ops.flash_attention_bias(*t, rel.to(torch.bfloat16), kpad)
    assert _err(a.float(), b.float()) > 0


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    x = _k5_inputs(S=45, masked_sample=0)
    names = ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")
    ref = jax_ops.attention_reference(*(_to_jax(x[n], "float32") for n in names), causal=causal)
    out = ops.attention_reference(*(_to_torch(x[n], "float32") for n in names), causal=causal)
    assert out.dtype == torch.float32
    assert _err(out.numpy(), ref) <= 1e-6


def _block_np(seed, C, Wd):
    """A stride-1 bottleneck block in the JAX layout (HWIO), with non-trivial frozen BN."""
    rng = np.random.RandomState(seed)
    conv = lambda kh, cin, cout: (rng.randn(kh, kh, cin, cout) * np.sqrt(2.0 / (kh * kh * cout))
                                  ).astype(np.float32)
    p = {"conv1": conv(1, C, Wd), "conv2": conv(3, Wd, Wd), "conv3": conv(1, Wd, C)}
    for name, c in (("bn1", Wd), ("bn2", Wd), ("bn3", C)):
        p[name] = {"scale": (1 + rng.randn(c) * 0.1).astype(np.float32),
                   "bias": (rng.randn(c) * 0.1).astype(np.float32),
                   "mean": (rng.randn(c) * 0.1).astype(np.float32),
                   "var": (np.abs(rng.randn(c)) + 0.5).astype(np.float32)}
    return p


K8_CASES = {
    "12x12_f32": dict(shape=(2, 12, 12, 16), dtype="float32"),
    "12x12_bf16": dict(shape=(2, 12, 12, 16), dtype="bfloat16"),
    "10x6_f32": dict(shape=(1, 10, 6, 16), dtype="float32"),
    "10x6_bf16": dict(shape=(1, 10, 6, 16), dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(K8_CASES))
def test_k8_plain_matches_jax_kernel(case):
    shape, dtype = K8_CASES[case]["shape"], K8_CASES[case]["dtype"]
    p = _block_np(5, shape[3], 8)
    x = (np.random.RandomState(6).randn(*shape) * 2).astype(np.float32)
    ref = np.asarray(jax_k8(jnp.asarray(x, jnp.dtype(dtype)), jax.tree.map(jnp.asarray, p)),
                     np.float32)
    tdt = getattr(torch, dtype)
    out = k8.fused_bottleneck(torch.from_numpy(x).to(tdt), block_from_jax(p, "cpu", tdt))
    assert out.dtype == tdt and tuple(out.shape) == shape
    lim = np.abs(ref).max() * (2.0 ** -6 if dtype == "bfloat16" else F32_TOL)
    assert _err(out.float().numpy(), ref) <= max(lim, F32_TOL), _err(out.float().numpy(), ref)


def test_k8_gradients_match_jax():
    """The Function's backward (the unfused block, recomputed) against jax.grad of
    fused_bottleneck, for x and every leaf of the block, BN mean and var included."""
    shape = (1, 8, 6, 16)
    p = _block_np(7, shape[3], 8)
    rng = np.random.RandomState(8)
    x = rng.randn(*shape).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)
    gx_j, gp_j = jax.grad(lambda x_, p_: jnp.sum(jax_k8(x_, p_) * cot), argnums=(0, 1))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))

    xt = torch.from_numpy(x).requires_grad_(True)
    pt = block_from_jax(p, "cpu", torch.float32)
    leaves = [pt["conv1"], pt["conv2"], pt["conv3"]] + [
        pt[bn][k] for bn in ("bn1", "bn2", "bn3") for k in ("scale", "bias", "mean", "var")]
    for t in leaves:
        t.requires_grad_(True)
    (k8.fused_bottleneck(xt, pt) * torch.from_numpy(cot)).sum().backward()

    pairs = [("x", xt.grad, np.asarray(gx_j))]
    for i in (1, 2, 3):  # HWIO → OIHW
        pairs.append((f"conv{i}", pt[f"conv{i}"].grad,
                      np.transpose(np.asarray(gp_j[f"conv{i}"]), (3, 2, 0, 1))))
        for k in ("scale", "bias", "mean", "var"):
            pairs.append((f"bn{i}/{k}", pt[f"bn{i}"][k].grad, np.asarray(gp_j[f"bn{i}"][k])))
    for name, got, want in pairs:
        assert got is not None and tuple(got.shape) == want.shape, name
        assert _err(got.numpy(), want) <= F32_TOL * np.abs(want).max(), name


def test_block_from_jax_matches_from_jax(tiny_tree):
    from musketeer_tpu_torch.params import from_jax

    cfg, tree = tiny_tree
    full = from_jax(tree, cfg, "cpu", torch.bfloat16)["encoder"]["resnet"]["layer1"]
    jl = tree["encoder"]["resnet"]["layer1"]
    rest0 = jax.tree.map(lambda a: a[0], jl["rest"])
    for got, want in ((block_from_jax(jl["first"], "cpu", torch.bfloat16), full[0]),
                      (block_from_jax(rest0, "cpu", torch.bfloat16), full[1])):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert full[1]["conv2"].is_contiguous(memory_format=torch.channels_last)


@pytest.fixture
def tiny_tree():
    import dataclasses

    from musketeer_tpu_torch.config import ofa_tiny
    from musketeer_tpu_torch.params import init_ofa_params

    cfg = dataclasses.replace(ofa_tiny(), use_flash_attention=True, encoder_layers=1,
                              decoder_layers=1, resnet_layers=(2, 1, 1))
    return cfg, init_ofa_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_cpu_wrappers_run_plain_versions_and_count_no_launches():
    k5.flash_attention_bias.launches = k5.flash_cross_attention.launches = 0
    k8.fused_bottleneck.launches = 0
    x = {n: _to_torch(a, "float32") for n, a in _k5_inputs(S=20).items()}
    args = [x[n] for n in ("q", "k", "v", "pos_q", "pos_k")]
    assert torch.equal(ops.flash_attention_bias(*args, x["rel"], x["kpad"], causal=True),
                       k5.flash_attention_bias_plain(*args, x["rel"], x["kpad"], causal=True))
    assert torch.equal(ops.flash_cross_attention(*args, x["kpad"]),
                       k5.flash_cross_attention_plain(*args, x["kpad"]))
    p = block_from_jax(_block_np(0, 16, 8), "cpu", torch.float32)
    xb = torch.randn(1, 5, 7, 16)
    assert torch.equal(k8.fused_bottleneck(xb, p), k8.fused_bottleneck_plain(xb, p))
    assert (k5.flash_attention_bias.launches, k5.flash_cross_attention.launches,
            k8.fused_bottleneck.launches) == (0, 0, 0)


def test_ops_exports_the_jax_ops_names():
    assert ops.__all__ == jax_ops.__all__
    for name in ops.__all__:
        assert callable(getattr(ops, name))


def test_wrappers_refuse_bad_inputs():
    x = {n: _to_torch(a, "float32") for n, a in _k5_inputs(S=20).items()}
    args = [x[n] for n in ("q", "k", "v", "pos_q", "pos_k")]
    with pytest.raises(ValueError, match="rel"):
        ops.flash_attention_bias(*args, x["rel"][:, :, :10], x["kpad"])
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention_bias(args[0].requires_grad_(True), *args[1:], x["rel"], x["kpad"])
    block = _block_np(0, 16, 8)
    with pytest.raises(ValueError, match="downsample"):
        k8.fused_bottleneck(torch.randn(1, 4, 4, 16), block_from_jax(
            dict(block, downsample_conv=np.zeros((1, 1, 16, 16), np.float32),
                 downsample_bn=block["bn3"]), "cpu", torch.float32))
    with pytest.raises(ValueError, match="conv1"):
        k8.fused_bottleneck(torch.randn(1, 4, 4, 32), block_from_jax(block, "cpu", torch.float32))


def test_k8_plain_matches_the_unfused_block():
    """The plain K8 and the port's unfused frozen-BN block, whose backward K8's
    Function recomputes, agree within fp32 rounding: folding BN changes only
    the rounding."""
    from musketeer_tpu_torch.models.resnet import _bottleneck

    p = block_from_jax(_block_np(3, 16, 8), "cpu", torch.float32)
    x = torch.randn(2, 9, 7, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = _bottleneck(x.permute(0, 3, 1, 2), p).permute(0, 2, 3, 1)
    assert _err(k8.fused_bottleneck_plain(x, p), ref) <= F32_TOL * max(1.0, float(ref.abs().max()))
