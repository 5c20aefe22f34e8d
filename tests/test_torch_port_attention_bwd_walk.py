"""The bf16 order and rounding of K4's tensor-core kernels, modelled on the CPU.

``csrc/flash_bwd_sm90.cuh`` runs K4 (``flash_attention_bwd``) in bf16 after a
pre-pass that forms dsum = rowsum(dO ∘ O): P = exp(w − lse) and
dW = P ∘ (dO·vᵀ − dsum) in fp32, then a key-major launch (per 64-key tile,
the 64-row q tiles in order: dv += Pᵀ·dO, dk += dWᵀ·q, dpos_k += dWᵀ·pos_q) and
a query-major one (per 64-row q tile, the batch rows and then the key tiles in
order: dq += dW·k, dpos_q += dW·pos_k, drel += dW). P and dW are rounded to bf16
once, as the A operands of the key-major products; dq and dpos_q take dW as
two bf16 operands, its rounding and the rounding of what is left, in two
products into one fp32 accumulator; the accumulators are fp32 and each
gradient is rounded once; drel sums the unrounded dW over the batch in order.
The kernels run only on the card; ``walk_bwd`` restates their order and
rounding in PyTorch so that the CPU can show that the rounding stays within
the tolerance ``chip_smoke.py`` phase 7 holds the kernels to on the card (2⁻⁶
of max(1, max|ref|)), here against the JAX package's Pallas kernels
(``_fwd(..., want_res=True)`` and ``_bwd``) run in interpret mode on the same
bf16 inputs, the walk taking JAX's o and lse as phase 7 gives K4 the plain
forward's. In fp32 the walk is the port's plain version, to 1e-5; and K3's lse
from K1's tile walk (``walk`` of ``test_torch_port_attention_walk.py``, which
the same core runs) is the plain lse.

The two cases with a fully masked row stay with ``test_torch_port_train_kernels.py``,
for the reasons given there (the JAX kernel spreads such a row over its padded
keys, and XLA:CPU flushes the 1e-38 floor).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu.ops.flash_attention_bwd import _bwd as jax_bwd
from musketeer_tpu.ops.flash_attention_bwd import _fwd as jax_fwd
from musketeer_tpu_torch.ops import flash_attention_bwd as kb
from musketeer_tpu_torch.ops import flash_attention_infer as k1
from tests.test_torch_port_attention_walk import BK, BQ, TOL, walk
from tests.test_torch_port_train_kernels import CASES, _inputs, _jax_args, _torch_args

GRADS = ("dq", "dk", "dv", "dpos_q", "dpos_k", "drel")
# the JAX comparison on train_kernels' cases without a fully masked row; the
# fp32 and lse checks also on a ragged case of two q tiles and three key tiles
WALK_CASES = [c for c in CASES if "mask_all" not in CASES[c]]
ALL_CASES = dict(CASES, ragged=dict(T=70, S=130))


def walk_bwd(q, k, v, pos_q, pos_k, rel, kpad, o, lse, do, causal=False, need_drel=True):
    """K4 as the tensor-core kernels walk it → (dq, dk, dv, dpos_q, dpos_k) in the
    inputs' dtypes and drel [H, T, S] fp32 (or None)."""
    B, H, T, D = q.shape
    S = k.shape[2]
    operand = lambda x: x.to(q.dtype).float()  # a product's A operand: bf16 once
    w = k1.attention_scores(q, k, pos_q, pos_k, rel, kpad, causal)  # fp32, masked
    p = torch.exp(w - lse[..., None])
    dof = do.float()
    dsum = (dof * o.float()).sum(-1, keepdim=True)  # the pre-pass
    dw = p * (dof @ v.float().transpose(-1, -2) - dsum)
    qf, pqf, kf, pkf = q.float(), pos_q.float(), k.float(), pos_k.float()
    tiles = lambda n, size: [slice(i, i + size) for i in range(0, n, size)]

    # key-major: each key tile sums its q tiles in order
    dk, dpk, dv = (torch.zeros(B, H, S, D) for _ in range(3))
    for ks in tiles(S, BK):
        for ts in tiles(T, BQ):
            pt = operand(p[:, :, ts, ks]).transpose(-1, -2)
            wt = operand(dw[:, :, ts, ks]).transpose(-1, -2)
            dv[:, :, ks] += pt @ dof[:, :, ts]
            dk[:, :, ks] += wt @ qf[:, :, ts]
            dpk[:, :, ks] += wt @ pqf[:, :, ts]

    # query-major: each q tile walks the batch rows, then the key tiles, in
    # order; dW enters as its bf16 high part, then the bf16 rounding of the rest
    dq, dpq = torch.zeros(B, H, T, D), torch.zeros(B, H, T, D)
    drel = torch.zeros(H, T, S) if need_drel and rel is not None else None
    for ts in tiles(T, BQ):
        for b in range(B):
            for ks in tiles(S, BK):
                wb = dw[b, :, ts, ks]
                hi = operand(wb)
                lo = operand(wb - hi)
                for part in (hi, lo):
                    dq[b, :, ts] += part @ kf[b, :, ks]
                for part in (hi, lo):
                    dpq[b, :, ts] += part @ pkf[b, :, ks]
                if drel is not None:
                    drel[:, ts, ks] += wb  # unrounded
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dpq.to(pos_q.dtype),
            dpk.to(pos_k.dtype), drel)


def _opts(case):
    c = ALL_CASES[case]
    return c.get("causal", False), c.get("skip_max", False)


@pytest.mark.parametrize("case", WALK_CASES)
def test_bf16_walk_matches_jax_kernels(case):
    x = _inputs(**ALL_CASES[case])
    causal, skip_max = _opts(case)
    B, _, T, _ = x["q"].shape
    need_drel = x["rel"] is not None
    o_j, res = jax_fwd(*_jax_args(x, jnp.bfloat16), causal, 128, True, skip_max=skip_max,
                       want_res=True)
    lse_j = np.array(res[6])[:B, :, :T, 0]  # the padded lse that rides the residuals
    do = jnp.asarray(x["do"], jnp.bfloat16)
    ref = jax_bwd(res, causal, 128, True, need_drel, do)
    t = _torch_args(x, torch.bfloat16)
    out = walk_bwd(*t, torch.from_numpy(np.asarray(o_j, np.float32)).to(torch.bfloat16),
                   torch.from_numpy(lse_j), torch.from_numpy(x["do"]).to(torch.bfloat16),
                   causal=causal)
    for name, a, b in zip(GRADS, out, ref):
        if not need_drel and name == "drel":
            assert a is None
            continue
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape, name
        err = float(np.abs(a.float().numpy() - b).max())
        lim = TOL * max(1.0, float(np.abs(b).max()))
        assert err <= lim, f"{case} {name}: max abs err {err} > {lim}"


def _plain_fwd(x, dtype, causal, skip_max):
    t = _torch_args(x, dtype)
    return t, kb.flash_attention_fwd_plain(*t, causal=causal, skip_max=skip_max)


@pytest.mark.parametrize("case", list(ALL_CASES))
def test_fp32_walk_is_the_plain_backward(case):
    x = _inputs(**ALL_CASES[case])
    causal, skip_max = _opts(case)
    t, (o, lse) = _plain_fwd(x, torch.float32, causal, skip_max)
    do = torch.from_numpy(x["do"])
    out = walk_bwd(*t, o, lse, do, causal=causal)
    ref = kb.flash_attention_bwd_plain(*t, o, lse, do, causal=causal)
    for name, a, b in zip(GRADS, out, ref):
        if b is None:
            assert a is None
            continue
        err = (a - b).abs().max().item()
        assert err <= 1e-5, f"{case} {name}: max abs err {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(ALL_CASES))
def test_k1_walk_lse_is_the_plain_lse(case, dtype):
    x = _inputs(**ALL_CASES[case])
    causal, skip_max = _opts(case)
    t, (o, lse) = _plain_fwd(x, dtype, causal, skip_max)
    out, lse_w = walk(*t, causal=causal, skip_max=skip_max, want_lse=True)
    # elementwise, relative to max(1, |lse|): a fully masked row's lse is -1e9
    err = ((lse_w - lse).abs() / lse.abs().clamp_min(1.0)).max().item()
    assert err <= 1e-5, f"{case}: lse rel err {err}"
    assert out.dtype == o.dtype


# K4's inputs at one batch row and head of a training call (B2 H12 T232 S232,
# causal, rel, bf16) and the gradients K4 gives on them on an NVIDIA H100 80GB
# HBM3 (700 W), dq and dpos_q on dW's two bf16 parts: chip_smoke.py's
# ``K4_SAVED_CASE``
SAVED_CASE = Path(__file__).resolve().parents[1] / "chip_smoke_cases" / "k4_causal_t232.pt"


def test_bf16_walk_is_k4_on_a_saved_training_input():
    """The walk gives the card's K4 gradients bit for bit on an input where
    K4's dq lay 1.78 bf16 steps (of max|dq|) from the function in fp32, and
    the plain version's 0.49, while dW entered dq's product rounded once to
    bf16; with dW's high and low bf16 parts, which the walk models, dq lies
    as far as the plain version's, within phase 7's one step over plain, and
    within phase 7's tolerance of the plain version."""
    case = torch.load(SAVED_CASE)
    args, kw = case["args"], dict(causal=case["causal"], need_drel=case["need_drel"])
    out = walk_bwd(*args, **kw)
    for name, a, b in zip(GRADS, out, case["k4_h100"]):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    plain = kb.flash_attention_bwd_plain(*args, **kw)
    fn = kb.flash_attention_bwd_plain(*[t.float() if t.is_floating_point() else t
                                        for t in args], **kw)
    for name, a, b in zip(GRADS, out, plain):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL * max(1.0, b.float().abs().max().item()), name
    step = 2.0 ** (np.floor(np.log2(fn[0].abs().max().item())) - 7)
    walk_steps, plain_steps = ((x.float() - fn[0]).abs().max().item() / step
                               for x in (out[0], plain[0]))
    assert 0.45 < walk_steps < 0.5 and 0.45 < plain_steps < 0.5, (walk_steps, plain_steps)
