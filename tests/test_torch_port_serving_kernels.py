"""K2-q8, K6 and K7 of the PyTorch port against the JAX package's Pallas kernels,
and the two int8 quantizers against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode, as the JAX package's own tests run them. Both
sides get the same numpy inputs, made from a seed, in float32. Tolerance:
the done rule's 1e-5 relative, as max|a − ref| over max|ref| (the two sides
sum in different orders; the −1e9 of padded vocab columns equal). The
quantizers must agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.ops.decode_cross_attn import decode_cross_attention_int8 as jax_k6
from musketeer_tpu.ops.decode_stack import decode_stack_step as jax_k7
from musketeer_tpu.ops.decode_stack import pack_decoder_weights as jax_pack
from musketeer_tpu.ops.decode_stack import transpose_cross_kv
from musketeer_tpu.ops.topk_projection import project_with_stats as jax_k2
from musketeer_tpu_torch.models import ofa
from musketeer_tpu_torch.ops import decode_cross_attn as k6
from musketeer_tpu_torch.ops import decode_stack as k7
from musketeer_tpu_torch.ops import topk_projection as k2
from tests.test_torch_port_model import REL_TOL, _err, _rel_err


def test_quantize_output_proj_matches_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    w = (rng.randn(1024, 96) * 96 ** -0.5).astype(np.float32)
    w[1000:] = 0.0  # padded vocab rows: scale floored at 1e-8 / 127
    w[3, :4] = [127.0, 2.5, -0.5, 3.5]  # scale exactly 1: half steps round to even
    w[3, 4:] = 0.0
    ref = jofa.quantize_output_proj({"embed_tokens": jnp.asarray(w)})
    out = ofa.quantize_output_proj({"embed_tokens": torch.from_numpy(w)})
    assert out["embed_tokens_q8"].dtype == torch.int8
    assert out["embed_tokens_scale"].dtype == torch.float32
    np.testing.assert_array_equal(out["embed_tokens_q8"].numpy(), np.asarray(ref["embed_tokens_q8"]))
    np.testing.assert_array_equal(out["embed_tokens_scale"].numpy(),
                                  np.asarray(ref["embed_tokens_scale"]))


def _q8(w):
    scale = np.maximum(np.abs(w).max(axis=1), 1e-8) / 127.0
    return np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8), scale.astype(np.float32)


@pytest.mark.parametrize("N,D,Vp,vocab_size", [(10, 64, 59520, 59457), (3, 256, 1024, 1000)])
def test_k2_q8_plain_matches_jax_kernel(N, D, Vp, vocab_size):
    rng = np.random.RandomState(2)
    h = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(Vp, D) * D ** -0.5).astype(np.float32)
    w[vocab_size:] = 0.0
    w8, scale = _q8(w)
    ref = jax_k2(jnp.asarray(h), jnp.asarray(w8), jnp.asarray(scale), vocab_size=vocab_size)
    out = k2.project_with_stats(torch.from_numpy(h), torch.from_numpy(w8), torch.from_numpy(scale),
                                vocab_size=vocab_size)
    for name, a, b in zip(("logits", "bmax", "Z"), out, ref):
        assert tuple(a.shape) == b.shape, name
        assert _rel_err(a.numpy(), b) <= REL_TOL, f"{name}: rel err {_rel_err(a.numpy(), b)}"
    assert (out[0][:, vocab_size:] == k2.NEG_INF).all()


def _k6_inputs(B=3, H=2, Kb=3, S=37, D=64, full_pad=2, seed=0):
    rng = np.random.RandomState(seed)
    pad = rng.rand(B, S) < 0.1
    if full_pad is not None:
        pad[full_pad] = True
    return dict(
        q=(rng.randn(B, H, Kb, D) * 0.3).astype(np.float32),
        k_i8=rng.randint(-127, 128, (B, H, S, D)).astype(np.int8),
        v_i8=rng.randint(-127, 128, (B, H, S, D)).astype(np.int8),
        k_scale=(rng.rand(B, H, S) * 0.02).astype(np.float32),
        v_scale=(rng.rand(B, H, S) * 0.02).astype(np.float32),
        bias=rng.randn(B, H, S).astype(np.float32),
        enc_pad=pad,
    )


K6_NAMES = ("q", "k_i8", "v_i8", "k_scale", "v_scale", "bias", "enc_pad")


@pytest.mark.parametrize("case", ["fully_padded_sample", "one_beam"])
def test_k6_plain_matches_jax_kernel(case):
    spec = dict(full_pad=2) if case == "fully_padded_sample" else dict(Kb=1, full_pad=None, seed=1)
    x = _k6_inputs(**spec)
    ref = np.asarray(jax_k6(*(jnp.asarray(x[n]) for n in K6_NAMES)))
    out = k6.decode_cross_attention_int8(*(torch.from_numpy(x[n]) for n in K6_NAMES))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    live = [b for b in range(ref.shape[0]) if not x["enc_pad"][b].all()]
    assert _rel_err(out[live].numpy(), ref[live]) <= REL_TOL
    if spec["full_pad"] is not None:
        # exact zeros, as the clamped max and the 1e-38 floor intend; XLA:CPU
        # flushes the subnormal floor, so the interpreted JAX kernel gives NaN
        # on this sample (ROADMAP §3)
        assert (out[spec["full_pad"]] == 0).all()


def make_stack_inputs(L, B, Kb, H, hd, f, Tmax, S, seed=4):
    """K7's inputs: an L-layer stack (d = H·hd) at rows = B samples × Kb beams,
    the JAX layers and the port's, the step's tensors; sample 0's last 5
    keys padded (folded into the bias)."""
    d, rows = H * hd, B * Kb
    rng = np.random.RandomState(seed)
    w = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)
    lin = lambda din, dout: {"w": w(L, din, dout), "b": w(L, dout)}
    ln = lambda: {"scale": (1 + rng.randn(L, d) * 0.1).astype(np.float32), "bias": w(L, d)}
    attn = lambda: {n: lin(d, d) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    layers = {"self_attn": attn(), "encoder_attn": attn(), "fc1": lin(d, f), "fc2": lin(f, d),
              "self_attn_layer_norm": ln(), "encoder_attn_layer_norm": ln(),
              "final_layer_norm": ln()}
    cbias = rng.randn(B, H, S).astype(np.float32)
    cbias[0, :, -5:] = k7.NEG_INF  # padded keys, folded into the bias
    x = dict(
        x0=rng.randn(rows, d).astype(np.float32),
        sbias=rng.randn(L, rows, H, Tmax).astype(np.float32),
        cbias=cbias,
        self_k=rng.randn(L, rows, H, Tmax, hd).astype(np.float32),
        self_v=rng.randn(L, rows, H, Tmax, hd).astype(np.float32),
        cross_k=rng.randn(L, B, H, S, hd).astype(np.float32),
        cross_v=rng.randn(L, B, H, S, hd).astype(np.float32),
    )
    # the port's per-layer layout: [dout, din] weights
    port_layers = [jax.tree.map(lambda a: torch.from_numpy(np.ascontiguousarray(
        a[i].T if a.ndim == 3 else a[i])), layers) for i in range(L)]
    return dict(layers=layers, port_layers=port_layers, x=x, Kb=Kb, Tmax=Tmax,
                scaling=float(hd * 2.0) ** -0.5)


@pytest.fixture(scope="module")
def stack_inputs():
    """A 2-layer stack (d 256, H 4, f 512) at rows 6 = 2 samples × 3 beams."""
    return make_stack_inputs(L=2, B=2, Kb=3, H=4, hd=64, f=512, Tmax=6, S=24)


@pytest.mark.parametrize("cache_index", [0, 2, 5])
def test_k7_plain_matches_jax_kernel(stack_inputs, cache_index):
    s = stack_inputs
    x = s["x"]
    kt, vt = transpose_cross_kv(jnp.asarray(x["cross_k"]), jnp.asarray(x["cross_v"]))
    ref = jax_k7(jax_pack(jax.tree.map(jnp.asarray, s["layers"]), jnp.float32),
                 jnp.asarray(x["x0"]), jnp.asarray(x["sbias"]), jnp.asarray(x["cbias"]),
                 jnp.asarray(x["self_k"]), jnp.asarray(x["self_v"]), kt, vt,
                 jnp.int32(cache_index), beam_size=s["Kb"], scaling=s["scaling"])
    pack = k7.pack_decoder_weights(s["port_layers"], torch.float32)
    out = k7.decode_stack_step(pack, *(torch.from_numpy(x[n]) for n in (
        "x0", "sbias", "cbias", "self_k", "self_v", "cross_k", "cross_v")),
        cache_index, beam_size=s["Kb"], scaling=s["scaling"])
    for name, a, b in zip(("x_out", "k_new", "v_new"), out, ref):
        assert tuple(a.shape) == b.shape, name
        assert _rel_err(a.numpy(), b) <= REL_TOL, f"{name}: rel err {_rel_err(a.numpy(), b)}"


def test_gelu_exact_matches_jax_restatement():
    from musketeer_tpu.ops.decode_stack import _gelu_exact as jax_gelu

    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    ref = np.asarray(jax_gelu(jnp.asarray(x)))
    assert _err(k7._gelu_exact(torch.from_numpy(x)).numpy(), ref) <= 1e-6
    xb = torch.from_numpy(x).to(torch.bfloat16)
    refb = np.asarray(jax_gelu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    # bf16: the same three roundings; erfc may differ by an fp32 ulp before the last
    assert _err(k7._gelu_exact(xb).float().numpy(), refb) <= 2.0 ** -7 * np.abs(refb).max()


def test_cpu_calls_leave_launch_counters_at_zero(stack_inputs):
    k2.project_with_stats.launches = k2.project_with_stats.launches_q8 = 0
    k6.decode_cross_attention_int8.launches = k7.decode_stack_step.launches = 0
    w8, scale = _q8(np.random.RandomState(0).randn(256, 64).astype(np.float32))
    k2.project_with_stats(torch.randn(4, 64), torch.from_numpy(w8), torch.from_numpy(scale))
    x = _k6_inputs()
    k6.decode_cross_attention_int8(*(torch.from_numpy(x[n]) for n in K6_NAMES))
    s = stack_inputs
    k7.decode_stack_step(k7.pack_decoder_weights(s["port_layers"], torch.float32),
                         *(torch.from_numpy(s["x"][n]) for n in (
                             "x0", "sbias", "cbias", "self_k", "self_v", "cross_k", "cross_v")),
                         1, beam_size=s["Kb"], scaling=s["scaling"])
    assert (k2.project_with_stats.launches, k2.project_with_stats.launches_q8,
            k6.decode_cross_attention_int8.launches, k7.decode_stack_step.launches) == (0, 0, 0, 0)


def test_wrappers_refuse_bad_inputs():
    w8, scale = _q8(np.random.RandomState(0).randn(256, 64).astype(np.float32))
    with pytest.raises(ValueError, match="w_scale"):
        k2.project_with_stats(torch.randn(4, 64), torch.from_numpy(w8))
    with pytest.raises(ValueError, match="w_scale"):
        k2.project_with_stats(torch.randn(4, 64), torch.randn(256, 64), torch.from_numpy(scale))
    x = {n: torch.from_numpy(a) for n, a in _k6_inputs().items()}
    with pytest.raises(ValueError, match="k_scale"):
        k6.decode_cross_attention_int8(x["q"], x["k_i8"], x["v_i8"], x["k_scale"][:, :1],
                                       x["v_scale"], x["bias"], x["enc_pad"])
    with pytest.raises(ValueError, match="int8"):
        k6.decode_cross_attention_int8(x["q"], x["k_i8"].float(), x["v_i8"], x["k_scale"],
                                       x["v_scale"], x["bias"], x["enc_pad"])
