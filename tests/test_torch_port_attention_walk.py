"""The bf16 tile walk of K1's tensor-core core, modelled on the CPU.

``csrc/flash_fwd_sm90.cuh`` runs K1 (``flash_attention_inference``) in bf16
as an online softmax over 64-row query tiles and 64-key tiles: fp32 scores,
a running max per row, ``e = exp(w − m)`` rounded to bf16 for P·v against
that running max while the denominator sums the unrounded ``e``, and the
accumulator rescaled whenever the max grows. The kernel runs only on the
card; ``walk`` restates its order of operations in PyTorch so that the CPU
can show the rounding it implies stays within the tolerance that
``chip_smoke.py`` phase 3 holds the kernel to on the card (2⁻⁶ of
max(1, max|ref|)), here against the JAX package's Pallas kernel run in
interpret mode on the same bf16 inputs. In fp32 the walk is the same
function as the port's plain version, to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu.ops.flash_attention_infer import flash_attention_inference as jax_k1
from musketeer_tpu_torch.ops import flash_attention_infer as k1
from tests.test_torch_port_kernels import K1_CASES, _k1_inputs

BQ = BK = 64        # the core's query rows per CTA and keys per tile
TOL = 2.0 ** -6     # chip_smoke.py's BF16_TOL, relative to max(1, max|ref|)
WALK_CASES = {name: {k: v for k, v in spec.items() if k not in ("dtype", "tol")}
              for name, spec in K1_CASES.items()}
# ragged query and key tiles: 70 = 64 + 6 rows, 150 = 2 x 64 + 22 keys
WALK_CASES["ragged_S"] = dict(T=70, S=150, rel=(72, 152))


def walk(q, k, v, pos_q, pos_k, rel, kpad, causal=False, skip_max=False, want_lse=False):
    """K1 as the tensor-core core walks it → ``[B, H, T, D]`` in q's dtype; with
    ``want_lse`` also K3's fp32 ``lse = m + log(l)`` (``log(max(l, 1e-38))``
    under ``skip_max``), which the same core writes for K3."""
    T, S = q.shape[2], k.shape[2]
    w_all = k1.attention_scores(q, k, pos_q, pos_k, rel, kpad, causal)  # fp32, masked
    vf = v.float()
    out = torch.empty(q.shape, dtype=torch.float32)
    lse = torch.empty(q.shape[:3], dtype=torch.float32)
    for t0 in range(0, T, BQ):
        w_rows = w_all[:, :, t0:t0 + BQ]
        shape = w_rows.shape[:-1] + (1,)
        m = torch.zeros(shape) if skip_max else torch.full(shape, -torch.inf)
        l = torch.zeros(shape)
        acc = torch.zeros(w_rows.shape[:-1] + (q.shape[-1],))
        for k0 in range(0, S, BK):
            w = w_rows[..., k0:k0 + BK]
            if not skip_max:
                m_new = torch.maximum(m, w.amax(-1, keepdim=True))
                scale = torch.exp(m - m_new)
                l, acc, m = l * scale, acc * scale, m_new
            e = torch.exp(w - m)
            l = l + e.sum(-1, keepdim=True)  # the unrounded e
            acc = acc + e.to(v.dtype).float() @ vf[:, :, k0:k0 + BK]
        denom = l.clamp_min(1e-38) if skip_max else l
        out[:, :, t0:t0 + BQ] = acc / denom
        lse[:, :, t0:t0 + BQ] = (torch.log(denom) if skip_max else m + torch.log(denom))[..., 0]
    return (out.to(q.dtype), lse) if want_lse else out.to(q.dtype)


def _case(name, dtype):
    spec = dict(WALK_CASES[name])
    kw = dict(causal=spec.pop("causal", False), skip_max=spec.pop("skip_max", False))
    x = _k1_inputs(**spec)
    t = {n: None if a is None else (torch.from_numpy(a) if a.dtype == bool
                                    else torch.from_numpy(a).to(dtype)) for n, a in x.items()}
    return x, t, kw


NAMES = ("q", "k", "v", "pos_q", "pos_k", "rel", "kpad")


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_bf16_walk_matches_jax_kernel(case):
    x, t, kw = _case(case, torch.bfloat16)

    def j(a):
        return None if a is None else jnp.asarray(a, jnp.bfloat16 if a.dtype != bool else bool)

    ref = np.asarray(jax_k1(*(j(x[n]) for n in NAMES), **kw), np.float32)
    out = walk(*(t[n] for n in NAMES), **kw)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    err = np.abs(out.float().numpy() - ref).max()
    lim = TOL * max(1.0, float(np.abs(ref).max()))
    assert err <= lim, f"{case}: max abs err {err} > {lim}"


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_fp32_walk_is_the_plain_function(case):
    _, t, kw = _case(case, torch.float32)
    args = [t[n] for n in NAMES]
    err = (walk(*args, **kw) - k1.flash_attention_plain(*args, **kw)).abs().max().item()
    assert err <= 1e-5, f"{case}: max abs err {err}"
