"""The bf16 order and rounding of K8's tensor-core route, modelled on the CPU.

K8's bf16 route (``csrc/bottleneck_sm90.cuh``, through
``ops/bottleneck.py::fused_bottleneck``) is an implicit GEMM on wgmma: a CTA
owns 16 × 8 output pixels and their 18 × 10 halo, whose x arrives by TMA with
the pixels off the image zero-filled. Its order and rounding:

- conv1 over the 180 halo pixels, summed in fp32 one 64-channel chunk after
  another; the epilogue rounds to bf16, applies the fp32 affine, relu, sets
  the halo pixels off the image to 0 (conv2's zero padding, not relu(b1)) and
  rounds; h1 stays in shared memory;
- conv2's nine taps, each a shifted view of h1 (a wgmma descriptor whose
  start moves by 16 (dy (TW + 2) + dx) bytes, 8-row groups 16 (TW + 2) bytes
  apart), all into one fp32 accumulator, tap by tap, each tap chunk by
  chunk, then one rounding, the affine, relu and a rounding;
- conv3 chunk by chunk, rounded, the affine, rounded, the residual added in
  bf16, relu.

The kernel runs only on the card; ``walk_k8`` restates that order and
rounding tile by tile, through the same halo and tap maps, so that the CPU
shows it stays within the tolerance ``chip_smoke.py`` holds the kernel to
(phase 17: 2⁻⁶ of max(1, max|ref|)), here against the JAX package's Pallas
kernel run in interpret mode on the same bf16 inputs. The maps are checked to
be bijections, and the plan and routing helpers are pure Python, tested with
no GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musketeer_tpu.ops.bottleneck import fused_bottleneck as jax_k8
from musketeer_tpu_torch.ops import _build
from musketeer_tpu_torch.ops import bottleneck as k8
from musketeer_tpu_torch.params import block_from_jax
from tests.test_torch_port_ops_kernels import _block_np

TOL = 2.0 ** -7 * 2  # chip_smoke.py's BF16_TOL
TH, TW = k8.SM90_TILE
HWP = TW + 2  # halo tile width
NH = k8.SM90_HALO  # halo pixels
KC = 64  # depth of a chunk


def halo_pixel(ty0: int, tx0: int, r: int):
    """The image pixel (row, column) of halo row r of the tile at (ty0, tx0):
    the TMA box starts at (ty0 − 1, tx0 − 1), columns fastest."""
    return ty0 - 1 + r // HWP, tx0 - 1 + r % HWP


def tap_row(wg: int, r: int, dy: int, dx: int) -> int:
    """The halo row that row r of warpgroup wg's A operand reads at tap (dy, dx):
    h1 is [Wd/8][halo pixel][8] without swizzle, so the descriptor starts at
    16 ((8 wg + dy)(TW + 2) + dx) bytes, its 8-row groups SBO = 16 (TW + 2)
    bytes apart and the rows of a core matrix 16 bytes apart."""
    addr = 16 * ((8 * wg + dy) * HWP + dx) + (r // 8) * 16 * HWP + (r % 8) * 16
    return addr // 16


def _chunked(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor = None) -> torch.Tensor:
    """acc + a · bᵀ in fp32, one 64-deep chunk after another (a [M, K], b [N, K])."""
    acc = torch.zeros(a.shape[0], b.shape[0]) if acc is None else acc
    for k0 in range(0, a.shape[1], KC):
        acc = acc + a[:, k0:k0 + KC].float() @ b[:, k0:k0 + KC].float().t()
    return acc


def walk_h1(x, b, ty0, tx0, w1, g1, b1):
    """conv1's epilogue over the halo of one tile → (h1 [NH, Wd] bf16, on-image mask)."""
    B, H, W, C = x.shape
    xa = torch.zeros(NH, C, dtype=x.dtype)  # TMA's zero fill off the image
    on = torch.zeros(NH, dtype=torch.bool)
    for r in range(NH):
        iy, ix = halo_pixel(ty0, tx0, r)
        if 0 <= iy < H and 0 <= ix < W:
            xa[r], on[r] = x[b, iy, ix], True
    acc = _chunked(xa, w1)
    h1 = torch.relu(acc.to(torch.bfloat16).float() * g1 + b1)
    return torch.where(on[:, None], h1, 0.0).to(torch.bfloat16), on


def walk_k8(x: torch.Tensor, p: dict) -> torch.Tensor:
    """bf16 K8 as the tensor-core route computes it: x [B, H, W, C] → [B, H, W, C]."""
    B, H, W, C = x.shape
    w1, w2, w3 = k8.sm90_weights(p)  # [Wd, C], [3, 3, Wd, Wd] (tap, out, in), [C, Wd]
    (g1, b1), (g2, b2), (g3, b3) = (k8.fold_bn(p[f"bn{i}"]) for i in (1, 2, 3))
    out = torch.empty_like(x)
    for b in range(B):
        for ty0 in range(0, H, TH):
            for tx0 in range(0, W, TW):
                h1, _ = walk_h1(x, b, ty0, tx0, w1, g1, b1)
                for wg in range(2):  # each warpgroup's 64 output pixels
                    acc = None
                    for t in range(9):
                        rows = [tap_row(wg, r, t // 3, t % 3) for r in range(64)]
                        acc = _chunked(h1[rows], w2[t // 3, t % 3], acc)
                    h2 = torch.relu(acc.to(torch.bfloat16).float() * g2 + b2).to(torch.bfloat16)
                    y = _chunked(h2, w3).to(torch.bfloat16).float() * g3 + b3
                    y = y.to(torch.bfloat16)
                    for r in range(64):
                        iy, ix = ty0 + 8 * wg + r // TW, tx0 + r % TW
                        if iy < H and ix < W:
                            out[b, iy, ix] = torch.relu(x[b, iy, ix] + y[r])
    return out


WALK_CASES = {
    "B2 20x12 C64 Wd64 (ragged rows and columns)": ((2, 20, 12, 64), 64),
    "B1 6x5 C128 Wd64 (an image smaller than one tile)": ((1, 6, 5, 128), 64),
    "B1 18x9 C128 Wd128 (ragged, two conv1 units a warpgroup)": ((1, 18, 9, 128), 128),
    "B1 16x8 C256 Wd192 (one tile, a partial conv2 pass)": ((1, 16, 8, 256), 192),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_bf16_k8_walk_matches_jax_kernel(case):
    shape, Wd = WALK_CASES[case]
    p = _block_np(7, shape[3], Wd)
    x = (np.random.RandomState(8).randn(*shape) * 2).astype(np.float32)
    ref = np.asarray(jax_k8(jnp.asarray(x, jnp.bfloat16), jax.tree.map(jnp.asarray, p)),
                     np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    pt = block_from_jax(p, "cpu", torch.bfloat16)
    out = walk_k8(xt, pt)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == shape
    lim = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out.float().numpy() - ref).max())
    assert err <= lim, f"{case}: max abs err {err} > {lim}"
    # and the port's plain version, the kernel's reference on the card
    plain = k8.fused_bottleneck_plain(xt, pt).float()
    assert float((out.float() - plain).abs().max()) <= TOL * max(1.0, float(plain.abs().max()))


def test_k8_halo_and_tap_maps_are_bijections():
    """Every output pixel of a tile reads, at each tap, exactly its own
    neighbour: (y + dy − 1, x + dx − 1) of the image; for one tap the 128 rows
    read 128 distinct halo pixels; the nine taps together read every halo
    pixel; the halo rows map one to one onto the 18 × 10 window."""
    ty0, tx0 = 32, 16
    window = {halo_pixel(ty0, tx0, r) for r in range(NH)}
    assert len(window) == NH == (TH + 2) * (TW + 2)
    assert window == {(ty0 - 1 + i, tx0 - 1 + j) for i in range(TH + 2) for j in range(TW + 2)}
    seen = set()
    for t in range(9):
        dy, dx = t // 3, t % 3
        rows = [tap_row(wg, r, dy, dx) for wg in range(2) for r in range(64)]
        assert len(set(rows)) == TH * TW and all(0 <= h < NH for h in rows)
        seen.update(rows)
        for wg in range(2):
            for r in range(64):
                y, xx = 8 * wg + r // TW, r % TW
                assert halo_pixel(ty0, tx0, tap_row(wg, r, dy, dx)) == \
                    (ty0 + y + dy - 1, tx0 + xx + dx - 1)
    assert seen == set(range(NH))


def test_k8_halo_off_the_image_is_zero_not_relu_b1():
    """At a corner tile with x = 0, conv1's products are 0, so h1 is relu(b1)
    on the image and exactly 0 on the halo pixels off it (conv2's padding)."""
    p = block_from_jax(_block_np(3, 64, 64), "cpu", torch.bfloat16)
    w1, _, _ = k8.sm90_weights(p)
    g1, b1 = k8.fold_bn(p["bn1"])
    x = torch.zeros(1, 5, 7, 64, dtype=torch.bfloat16)
    h1, on = walk_h1(x, 0, 0, 0, w1, g1, b1)
    assert int(on.sum()) == 5 * 7 and not bool(on[0])  # the corner (-1, -1) is off the image
    assert bool((h1[~on] == 0).all())
    assert torch.equal(h1[on].float(), torch.relu(b1).to(torch.bfloat16).float().expand(35, -1))
    assert float(torch.relu(b1).max()) > 0


@pytest.mark.parametrize("B,H,W,C,Wd,grid,stages", [(16, 120, 120, 256, 64, (15, 8, 16), 2),
                                                    (16, 60, 60, 512, 128, (8, 4, 16), 8),
                                                    (16, 30, 30, 1024, 256, (4, 2, 16), 4)])
def test_k8_plan_fits_shared_memory_at_the_model_shapes(B, H, W, C, Wd, grid, stages):
    plan = k8.sm90_plan(B, H, W, C, Wd)
    assert plan["smem"] <= _build.SMEM_MAX and plan["stages"] == stages
    assert plan["grid"] == grid and plan["nb"] == (64 if Wd == 64 else 128)
    # h1 [Wd/8][180][8], h2 [Wd/8][128][8] (or conv1's two 24 KB x slots),
    # the 16 KB stages, g1, b1, g2, b2 and two 128-column g3, b3 slices in
    # fp32, 22 mbarriers and 1 KB of alignment slack
    h1 = -(-NH * Wd * 2 // 1024) * 1024
    affines = 4 * 4 * Wd + 2 * 2 * 4 * 128
    assert plan["smem"] == (1024 + h1 + max(128 * Wd * 2, 2 * 24576) + stages * 16384 + affines
                            + 176)
    room = _build.SMEM_MAX if Wd > 64 else k8.SM_SMEM // 2 - 1024  # Wd 64: two CTAs an SM
    assert plan["smem"] <= room
    assert k8.sm90_smem(Wd, stages + 1) > room or stages == k8.SM90_MAX_STAGES


def test_k8_plan_raises_where_nothing_fits():
    assert k8.sm90_plan(1, 8, 8, 64, 192)["stages"] == 6  # Wd 192: six stages fit
    with pytest.raises(ValueError, match="shared memory"):
        k8.sm90_plan(1, 8, 8, 64, 264)  # Wd 264 pads to 320
    with pytest.raises(ValueError, match="multiples of 8"):
        k8.sm90_plan(1, 8, 8, 60, 64)
    with pytest.raises(ValueError, match="multiples of 8"):
        k8.sm90_plan(1, 8, 8, 64, 36)


def test_k8_sm90_weights_are_k_major():
    p = block_from_jax(_block_np(1, 64, 16), "cpu", torch.float32)
    w1, w2, w3 = k8.sm90_weights(p)
    assert all(w.dtype == torch.bfloat16 and w.is_contiguous() for w in (w1, w2, w3))
    bf = lambda t: t.to(torch.bfloat16)
    assert torch.equal(w1, bf(p["conv1"][:, :, 0, 0]))  # [Wd, C]: out, in
    assert torch.equal(w3, bf(p["conv3"][:, :, 0, 0]))  # [C, Wd]
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(w2[dy, dx], bf(p["conv2"][:, :, dy, dx]))  # [out, in]


def test_k8_route_picks_plain_fma_or_tensor_cores():
    cuda = torch.device("cuda")  # the helpers read only the device's type: no card needed
    x = torch.empty(2, 30, 30, 1024, dtype=torch.bfloat16)
    p = block_from_jax(_block_np(0, 1024, 256), "cpu", torch.bfloat16)
    w = k8.sm90_weights(p)
    assert k8._route(torch.device("cpu"), x, w) == "plain"
    assert k8._route(cuda, x, w) == "sm90"
    assert k8._route(cuda, x.float()) == "fma"
    with pytest.raises(TypeError, match="dtype"):
        k8._route(cuda, x.half())
    with pytest.raises(ValueError, match="16-byte"):  # C 12: rows of 24 bytes
        k8._route(cuda, torch.empty(1, 4, 4, 12, dtype=torch.bfloat16))
    buf = torch.empty(x.numel() + 64, dtype=torch.bfloat16)
    base = -buf.data_ptr() % 16 // 2
    with pytest.raises(ValueError, match="16-byte"):  # x off by 8 bytes
        k8._route(cuda, buf[base + 4:base + 4 + x.numel()].view(x.shape), w)
    w12 = k8.sm90_weights(block_from_jax(_block_np(0, 64, 12), "cpu", torch.bfloat16))
    with pytest.raises(ValueError, match="16-byte"):  # Wd 12: w2 and w3 rows of 24 bytes
        k8._route(cuda, torch.empty(1, 4, 4, 64, dtype=torch.bfloat16), w12)


def test_k8_bn_vector_is_the_fold_kernels_layout():
    """The fold kernel reads scale, var, bias, mean, each bn1, bn2, bn3 (Wd, Wd
    and C long), and writes g1, g2, g3 then b1, b2, b3: fold_bn's arithmetic
    on that layout gives fold_bn's vectors in the kernels' order."""
    p = block_from_jax(_block_np(2, 64, 16), "cpu", torch.float32)
    v = k8._bn_vector(p)
    assert v.dtype == torch.float32 and v.numel() == 4 * (2 * 16 + 64)
    scale, var, bias, mean = v.view(4, -1)
    g = scale * torch.rsqrt(var + k8.BN_EPS)
    folds = [k8.fold_bn(p[f"bn{i}"]) for i in (1, 2, 3)]
    want = torch.cat([g for g, _ in folds] + [b for _, b in folds])
    assert torch.equal(torch.cat([g, bias - mean * g]), want)
