"""K1 and K2 of the PyTorch port against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode. Both get the same numpy inputs, made from a
seed. Tolerance: 1e-5 max abs in float32 (the two sides sum in different
orders); the bf16 case allows two bf16 ulps at 1 (the probabilities are
rounded to bf16 before P·v on both sides, after fp32 sums that differ in
their last bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu.ops.flash_attention_infer import flash_attention_inference as jax_k1
from musketeer_tpu.ops.topk_projection import project_with_stats as jax_k2
from musketeer_tpu.ops.topk_projection import select_candidate_blocks as jax_select
from musketeer_tpu_torch.ops import flash_attention_infer as k1
from musketeer_tpu_torch.ops import topk_projection as k2

K1_CASES = {
    # rel wider than the stream, as the JAX encoder composes it
    "self_rel_wider_than_S": dict(T=40, S=40, rel=(48, 56)),
    "causal": dict(T=40, S=40, rel=(40, 40), causal=True),
    "cross_rel_none": dict(T=5, S=37, rel=None),
    "skip_max": dict(T=40, S=40, rel=(40, 40), skip_max=True),
    # every key of batch row 1 padded: −1e9 everywhere gives the mean of v
    "fully_masked_row": dict(T=24, S=24, rel=(24, 24), mask_all=1),
    "bf16": dict(T=40, S=40, rel=(48, 56), dtype="bfloat16", tol=1.6e-2),
}


def _k1_inputs(T, S, rel, dtype="float32", mask_all=None, seed=0, B=2, H=3, D=64):
    rng = np.random.RandomState(seed)
    arr = lambda *shape: (rng.randn(*shape) * 0.5).astype(np.float32)
    x = dict(q=arr(B, H, T, D), k=arr(B, H, S, D), v=arr(B, H, S, D),
             pos_q=arr(B, H, T, D), pos_k=arr(B, H, S, D))
    x["rel"] = None if rel is None else arr(H, *rel)
    kpad = rng.rand(B, S) < 0.2
    if mask_all is not None:
        kpad[mask_all] = True
    x["kpad"] = kpad
    return x


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_plain_matches_jax_kernel(case):
    spec = dict(K1_CASES[case])
    tol = spec.pop("tol", 1e-5)
    causal = spec.pop("causal", False)
    skip_max = spec.pop("skip_max", False)
    dtype = spec.get("dtype", "float32")
    x = _k1_inputs(**spec)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def j(a):
        return None if a is None else jnp.asarray(a, jdt if a.dtype != bool else bool)

    def t(a):
        return None if a is None else (torch.from_numpy(a) if a.dtype == bool
                                       else torch.from_numpy(a).to(tdt))

    names = ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")
    ref = jax_k1(*(j(x[n]) for n in names), causal=causal, skip_max=skip_max)
    out = k1.flash_attention_inference(*(t(x[n]) for n in names), causal=causal, skip_max=skip_max)
    assert out.dtype == tdt and out.shape == ref.shape
    err = np.abs(out.float().numpy() - np.asarray(ref, np.float32)).max()
    assert err <= tol, f"{case}: max abs err {err}"
    if "mask_all" in spec:
        mean_v = x["v"][spec["mask_all"]].mean(axis=1)  # [H, D]
        np.testing.assert_allclose(out[spec["mask_all"]].numpy(),
                                   np.broadcast_to(mean_v[:, None], out.shape[1:]), atol=1e-5)


@pytest.mark.parametrize("N,D,Vp,vocab_size", [(10, 64, 59520, 59457), (3, 256, 1024, 1000)])
def test_k2_plain_matches_jax_kernel(N, D, Vp, vocab_size):
    rng = np.random.RandomState(1)
    h = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(Vp, D) * D ** -0.5).astype(np.float32)
    w[vocab_size:] = 0.0
    ref = jax_k2(jnp.asarray(h), jnp.asarray(w), vocab_size=vocab_size)
    out = k2.project_with_stats(torch.from_numpy(h), torch.from_numpy(w), vocab_size=vocab_size)
    for name, a, b in zip(("logits", "bmax", "Z"), out, ref):
        assert tuple(a.shape) == b.shape, name
        err = np.abs(a.numpy() - np.asarray(b)).max()
        assert err <= 1e-5, f"{name}: max abs err {err}"
    assert (out[0][:, vocab_size:] == k2.NEG_INF).all()

    nb_sel = 7
    vals_j, ids_j = jax_select(*ref[:2], nb_sel)
    vals_t, ids_t = k2.select_candidate_blocks(out[0], out[1], nb_sel)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert np.abs(vals_t.numpy() - np.asarray(vals_j)).max() <= 1e-5


def test_top_k_stable_keeps_index_order_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e9, 3.0, -1e9]])
    vals, idx = k2.top_k_stable(x, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0, -1e9]]


def test_cpu_calls_leave_launch_counters_at_zero():
    k1.flash_attention_inference.launches = 0
    k2.project_with_stats.launches = 0
    x = _k1_inputs(T=8, S=8, rel=(8, 8))
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    k1.flash_attention_inference(t["q"], t["k"], t["v"], t["pos_q"], t["pos_k"], t["rel"], t["kpad"])
    k2.project_with_stats(torch.randn(4, 64), torch.randn(256, 64), vocab_size=200)
    assert k1.flash_attention_inference.launches == 0
    assert k2.project_with_stats.launches == 0


def test_wrappers_refuse_bad_inputs():
    x = {n: torch.from_numpy(a) for n, a in _k1_inputs(T=8, S=8, rel=(8, 8)).items()}
    with pytest.raises(ValueError, match="rel"):
        k1.flash_attention_inference(x["q"], x["k"], x["v"], x["pos_q"], x["pos_k"],
                                     x["rel"][:, :4], x["kpad"])
    with pytest.raises(ValueError, match="kpad"):
        k1.flash_attention_inference(x["q"], x["k"], x["v"], x["pos_q"], x["pos_k"],
                                     x["rel"], x["kpad"].float())
    with pytest.raises(ValueError, match="Vp"):
        k2.project_with_stats(torch.randn(4, 64), torch.randn(200, 64))
