"""K3 and K4 of the PyTorch port against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode, as ``tests/test_flash_attention.py`` runs them.
Both sides get the same numpy inputs at scale 0.3, made from a seed.
Tolerances: K3's output and logsumexp to 1e-5 in fp32 (different summation
orders); the six gradients of the autograd Function against ``jax.vjp`` of
``flash_attention_bias_trainable`` to 2e-4 absolute (the bound of
``tests/test_flash_attention.py``); the plain K4 against autograd of the
plain forward to 1e-5.

Fully masked rows (ROADMAP §3). Under ``skip_max`` the port floors the
denominator at 1e-38 and gives o = 0, lse = log(1e-38), as the JAX kernel's
comment intends; XLA:CPU flushes that subnormal floor to zero, so the JAX
kernel gives NaN there: the K3 check compares the other rows and holds the
masked row to those values, and the gradient check leaves that case to the
autograd comparison. Without ``skip_max`` the JAX kernel spreads the row
over its 128-padded keys, so that case uses S = 128, where the two agree;
there the saved logsumexp rounds to −1e9 in fp32 and both backwards take
P = 1 on the row, which is not the forward's derivative, so the autograd
check leaves that case out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu.ops.flash_attention_bwd import _fwd as jax_fwd
from musketeer_tpu.ops.flash_attention_bwd import flash_attention_bias_trainable as jax_trainable
from musketeer_tpu_torch.ops import flash_attention_bwd as kb
from musketeer_tpu_torch.ops import flash_attention_infer as k1

NAMES = ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")
CASES = {
    "self": dict(T=40, S=40),
    "causal": dict(T=40, S=40, causal=True),
    "cross_rel_none": dict(T=5, S=37, rel=False),
    "skip_max": dict(T=40, S=40, skip_max=True),
    "masked_row_skip_max": dict(T=24, S=24, skip_max=True, mask_all=1),
    "masked_row_S128": dict(T=20, S=128, mask_all=0),
    "odd_batch": dict(B=3, T=33, S=33, causal=True),
}


def _inputs(T, S, B=2, H=3, D=64, rel=True, mask_all=None, seed=0, **_):
    rng = np.random.RandomState(seed)
    arr = lambda *shape: (rng.randn(*shape) * 0.3).astype(np.float32)
    x = dict(q=arr(B, H, T, D), k=arr(B, H, S, D), v=arr(B, H, S, D),
             pos_q=arr(B, H, T, D), pos_k=arr(B, H, S, D),
             rel=arr(H, T, S) if rel else None)
    kpad = rng.rand(B, S) < 0.2
    if mask_all is not None:
        kpad[mask_all] = True
    x["kpad"] = kpad
    x["do"] = arr(B, H, T, D)  # cotangent of the output
    return x


def _jax_args(x, dtype=jnp.float32):
    T, S = x["q"].shape[2], x["k"].shape[2]
    rel = x["rel"] if x["rel"] is not None else np.zeros((x["q"].shape[1], T, S), np.float32)
    return [jnp.asarray(x[n], dtype) for n in ("q", "k", "v", "pos_q", "pos_k")] + \
        [jnp.asarray(rel, dtype), jnp.asarray(x["kpad"])]


def _torch_args(x, dtype=torch.float32, grad=False):
    out = []
    for n in NAMES:
        a = x[n]
        if a is None or a.dtype == bool:
            out.append(None if a is None else torch.from_numpy(a))
        else:
            out.append(torch.from_numpy(a).to(dtype).requires_grad_(grad))
    return out


def _opts(case):
    c = CASES[case]
    return c.get("causal", False), c.get("skip_max", False)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("case", list(CASES))
def test_k3_plain_matches_jax_fwd(case):
    x = _inputs(**CASES[case])
    causal, skip_max = _opts(case)
    o_j, lse_j = jax_fwd(*_jax_args(x), causal, 128, True, skip_max=skip_max)
    o_t, lse_t = kb.flash_attention_fwd(*_torch_args(x), causal=causal, skip_max=skip_max)
    assert o_t.dtype == torch.float32 and lse_t.dtype == torch.float32
    assert tuple(o_t.shape) == o_j.shape and tuple(lse_t.shape) == lse_j.shape
    rows = np.arange(o_j.shape[0])
    if skip_max and "mask_all" in CASES[case]:
        masked = CASES[case]["mask_all"]
        assert not o_t[masked].any()
        np.testing.assert_allclose(lse_t[masked].numpy(), np.log(np.float32(1e-38)), rtol=1e-6)
        rows = rows[rows != masked]
    assert _err(o_t.numpy()[rows], np.asarray(o_j)[rows]) <= 1e-5, case
    np.testing.assert_allclose(lse_t.numpy()[rows], np.asarray(lse_j)[rows], rtol=1e-6, atol=1e-5)


def test_k3_plain_matches_jax_fwd_bf16():
    x = _inputs(T=40, S=40)
    o_j, lse_j = jax_fwd(*_jax_args(x, jnp.bfloat16), False, 128, True)
    o_t, lse_t = kb.flash_attention_fwd(*_torch_args(x, torch.bfloat16))
    assert o_t.dtype == torch.bfloat16
    # P is rounded to bf16 before P·v on both sides, after fp32 sums that may
    # differ in their last bits: two bf16 steps at the output's scale
    assert _err(o_t.float().numpy(), np.asarray(o_j, np.float32)) <= 1.6e-2
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4)


def _port_grads(x, causal, skip_max):
    args = _torch_args(x, grad=True)
    o = kb.flash_attention(*args, causal=causal, skip_max=skip_max)
    assert type(o.grad_fn).__name__ == "FlashAttentionTrainableBackward"
    (o * torch.from_numpy(x["do"])).sum().backward()
    grads = [a.grad for a in args[:5]] + [None if args[5] is None else args[5].grad]
    return o.detach(), grads


@pytest.mark.parametrize("case", [c for c in CASES if c != "masked_row_skip_max"])
def test_function_grads_match_jax_vjp(case):
    x = _inputs(**CASES[case])
    causal, skip_max = _opts(case)
    need_drel = x["rel"] is not None
    ja = _jax_args(x)

    def f(q, k, v, pq, pk, rel):
        return jax_trainable(q, k, v, pq, pk, rel, ja[6], causal, 128, False, need_drel, skip_max)

    o_j, vjp = jax.vjp(f, *ja[:6])
    g_j = vjp(jnp.asarray(x["do"]))
    o_t, g_t = _port_grads(x, causal, skip_max)
    assert _err(o_t.numpy(), o_j) <= 1e-5
    names = ("dq", "dk", "dv", "dpos_q", "dpos_k", "drel")
    for name, a, b in zip(names, g_t, g_j):
        if name == "drel" and not need_drel:
            assert a is None
            continue
        assert a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert _err(a.numpy(), b) <= 2e-4, f"{case} {name}: {_err(a.numpy(), b)}"


@pytest.mark.parametrize("case", [c for c in CASES if c != "masked_row_S128"])
def test_k4_plain_matches_autograd_of_plain_forward(case):
    x = _inputs(**CASES[case])
    causal, skip_max = _opts(case)
    args = _torch_args(x, grad=True)
    o, lse = kb.flash_attention_fwd_plain(*args, causal=causal, skip_max=skip_max)
    do = torch.from_numpy(x["do"])
    (o * do).sum().backward()
    ref = [a.grad for a in args[:5]] + [None if args[5] is None else args[5].grad]
    plain = kb.flash_attention_bwd(*(a.detach() if a is not None else None for a in args[:6]),
                                   args[6], o.detach(), lse.detach(), do, causal=causal)
    for i, (a, b) in enumerate(zip(plain, ref)):
        if b is None:
            assert a is None
            continue
        assert _err(a.numpy(), b.numpy()) <= 1e-5, f"{case} grad {i}"


def test_dispatcher_picks_k1_without_grad_and_the_function_with_it():
    x = _inputs(T=16, S=16)
    with torch.no_grad():
        out = kb.flash_attention(*_torch_args(x, grad=True))
    assert out.grad_fn is None
    ref = k1.flash_attention_inference(*_torch_args(x))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    out = kb.flash_attention(*_torch_args(x, grad=True))
    assert type(out.grad_fn).__name__ == "FlashAttentionTrainableBackward"
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=1e-6)
    # only the rel bias tracked (a frozen model with trainable tables) still differentiates
    args = _torch_args(x)
    args[5].requires_grad_(True)
    assert kb.flash_attention(*args).grad_fn is not None


def test_k1_refuses_inputs_that_autograd_tracks():
    x = _inputs(T=16, S=16)
    with pytest.raises(RuntimeError, match="no backward"):
        k1.flash_attention_inference(*_torch_args(x, grad=True))
    args = _torch_args(x)
    args[5].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        k1.flash_attention_inference(*args)


def test_cpu_calls_leave_k3_k4_counters_at_zero():
    kb.flash_attention_fwd.launches = kb.flash_attention_bwd.launches = 0
    x = _inputs(T=8, S=8)
    out = kb.flash_attention(*_torch_args(x, grad=True), causal=True)
    out.sum().backward()
    assert kb.flash_attention_fwd.launches == 0 and kb.flash_attention_bwd.launches == 0


def test_rel_wider_than_the_stream_gets_a_matching_gradient():
    """The encoder may compose rel wider than [T, S]: the gradient keeps its
    shape, with zeros outside the top-left block."""
    x = _inputs(T=12, S=12)
    args = _torch_args(x, grad=True)
    wide = torch.nn.functional.pad(args[5].detach(), (0, 5, 0, 3)).requires_grad_(True)
    o = kb.flash_attention(*args[:5], wide, args[6])
    (o * torch.from_numpy(x["do"])).sum().backward()
    o2 = kb.flash_attention(*args[:5], args[5], args[6])
    (o2 * torch.from_numpy(x["do"])).sum().backward()
    assert wide.grad.shape == wide.shape
    torch.testing.assert_close(wide.grad[:, :12, :12], args[5].grad, rtol=0, atol=1e-6)
    assert not wide.grad[:, 12:].any() and not wide.grad[:, :, 12:].any()
