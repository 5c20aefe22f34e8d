"""K7: all L decoder layers of one incremental decode step in one call.

Port of ``musketeer_tpu/ops/decode_stack.py::decode_stack_step`` (Pallas
``_kernel``, with ``pack_decoder_weights`` and ``_gelu_exact``). Per layer,
on the step's hidden state ``x [rows, d]`` (rows = samples × beams):

1. self-attention over the growing cache: LN, the fused q|k|v product, the
   scores of the cached prefix with the current position's K/V substituted,
   softmax, the value product, the out-projection and the residual;
2. beam-shared cross-attention: LN, the cross q product, a sample's beams
   against its K/V ``[S, hd]`` with the bias row (pads folded to −1e9),
   softmax, the value product, the out-projection and the residual;
3. the FFN: LN, fc1, erf-gelu, fc2, the residual.

It returns ``x_out [rows, d]`` and the step's new self K/V ``k_new, v_new
[L, rows, d]``, which the caller writes into the cache at ``cache_index``.

Numerics are the TPU kernel's: every product accumulates in fp32 and is
rounded to the compute dtype before its bias (``_dot``), the self
out-projection is one fp32 sum rounded once, LayerNorm is fp32 with eps
1e-5, the probabilities are rounded to the compute dtype before each value
product, and gelu is ``_gelu_exact``'s three roundings around an fp32 erfc
(PyTorch's ``erfc`` here, CUDA's ``erfcf`` in the kernel, in place of the
TPU kernel's restated XLA expansion).

The TPU kernel streams the cross K/V in a transposed, S-padded layout
(``transpose_cross_kv``), a constraint of its DMAs; here the cross K/V are
read in the cache's own ``[L, B, H, S, hd]`` layout, in the compute dtype.

``decode_stack_step`` runs the plain PyTorch version for CPU tensors and the
CUDA kernels (``csrc/decode_stack.cu``, one C call per step) for CUDA
tensors, picked by dtype (``_build.route``): bf16 on the tensor cores (the
six products on the weight-streaming core of ``csrc/skinny_gemm_sm90.cuh``,
split over the card's SMs as ``split_plan`` says; the cross-attention on
``csrc/decode_attn_sm90.cuh``, each launched with programmatic dependent
launch), its launches also counted in
``decode_stack_step.launches_sm90``; fp32 on the FMA kernels, which the exact
fp32 checks hold to the plain version. Both routes are compiled at the tile
widths ``_build.HEAD_DIMS`` (32, 64, 80, 128, 192, 256): a head dim up to 256
runs on the smallest that covers it; where it is not a multiple of 8 the
four caches go to the kernels as zero-padded copies (rows of whole 16-byte
units; counted in ``.padded``), the hidden state keeping the model's head
stride. Past 128 (``.wide``) the cross-attention's ring is shallower
(``cross_stages``), the bf16 self-attention holds q in shared memory and
the fp32 cross-attention takes each key row 64 dims at a time. Any head dim
past 256 runs on the deep route (``.deep``): the attentions stream the head
dim in chunks of 128 (the cross-attention's key tiles, the self-attention's
q and key rows; the fp32 cross-attention's q 64 dims at a time) and split
their outputs' columns into blocks of 128 over the grid, on the instance
128's tiles and ring. Unaligned bf16 inputs raise; it never falls back from
one version to another.

Both routes take every beam count, encoder length S, cache length Tmax and
width d that the Pallas kernel takes; ``stack_plan`` names the route a step
takes, and counters record it: the cross-attention runs a sample's beams in
tiles of 16 (``.beam_tiled``) and, where a tile's whole score rows do not
fit in shared memory, its scores in chunks, two passes over K
(``.chunked``); the self-attention past ``SA_CHUNK`` positions computes the
later scores again (``.cache_chunked``); a width that is not a multiple of
64 runs the products on a zero-filled last chunk (``.ragged``). These are
routes of one kernel picked by the shape, not fallbacks: nothing is retried.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e9
BEAM_TILE = 16  # beams of one cross-attention CTA: one m16 A tile (the FMA route: 16 rows)
SA_CHUNK = 2048  # cached positions whose scores the self-attention keeps in shared memory
FMA_CHUNK = 1024  # keys of a score chunk of the fp32 cross-attention, where S does not fit
_DTYPES = (torch.float32, torch.bfloat16)
_PACK = ("w_self3", "b_self3", "w_so", "w_cq", "w_co", "w_fc1", "b_fc1", "w_fc2", "b_misc", "ln")
_SIG = (_build.PTR,) * 21 + (_build.INT,) * 8 + (_build.FLOAT,) + (_build.INT,) * 2 + (_build.PTR,)
_SIG_SM90 = (_build.PTR,) * 24 + (_build.INT,) * 8 + (_build.FLOAT,) + (_build.INT,) * 8 + (_build.PTR,)
MAX_CPS = 16  # 64-deep chunks of one split (csrc/skinny_gemm_sm90.cuh)
MAX_SPLITS = 4  # splits of one product that fit MAX_CPS: the last CTA of a tile adds them in turn

Pack = Dict[str, torch.Tensor]


def pack_decoder_weights(dec_layers: List[dict], dtype: torch.dtype) -> Pack:
    """Stack the per-layer decoder weights into the kernel's layout, once per decode session.

    Linear weights keep the port's ``[dout, din]`` rows (contiguous along the
    input, as a small-M product reads them): ``w_self3 [L, 3d, d]`` (q|k|v),
    ``w_so``, ``w_cq``, ``w_co [L, d, d]``, ``w_fc1 [L, f, d]``, ``w_fc2 [L, d, f]``;
    biases ``b_self3 [L, 3d]``, ``b_fc1 [L, f]``, ``b_misc [L, 4, d]`` (self out,
    cross q, cross out, fc2), all in ``dtype``; ``ln [L, 6, d]`` fp32 (self,
    cross and final LayerNorm scale and bias)."""
    def stack(get, dt=dtype):
        return torch.stack([get(p).to(dt) for p in dec_layers]).contiguous()

    sa, ca = "self_attn", "encoder_attn"
    return {
        "w_self3": stack(lambda p: torch.cat([p[sa][n]["w"] for n in ("q_proj", "k_proj", "v_proj")])),
        "b_self3": stack(lambda p: torch.cat([p[sa][n]["b"] for n in ("q_proj", "k_proj", "v_proj")])),
        "w_so": stack(lambda p: p[sa]["out_proj"]["w"]),
        "w_cq": stack(lambda p: p[ca]["q_proj"]["w"]),
        "w_co": stack(lambda p: p[ca]["out_proj"]["w"]),
        "w_fc1": stack(lambda p: p["fc1"]["w"]),
        "b_fc1": stack(lambda p: p["fc1"]["b"]),
        "w_fc2": stack(lambda p: p["fc2"]["w"]),
        "b_misc": stack(lambda p: torch.stack([p[sa]["out_proj"]["b"], p[ca]["q_proj"]["b"],
                                               p[ca]["out_proj"]["b"], p["fc2"]["b"]])),
        "ln": stack(lambda p: torch.stack([p[n][k] for n in ("self_attn_layer_norm",
                                                             "encoder_attn_layer_norm",
                                                             "final_layer_norm")
                                           for k in ("scale", "bias")]), torch.float32),
    }


def _scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a Python scalar multiplied into an array."""
    return float(torch.tensor(value, dtype=dtype))


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ wᵀ with fp32 sums, rounded to a's dtype (the TPU kernel's ``_dot``)."""
    return (a.float() @ w.float().t()).to(a.dtype)


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], scale, bias, 1e-5).to(x.dtype)


def _gelu_exact(h: torch.Tensor) -> torch.Tensor:
    """0.5·h·erfc(−h/√2): the product and the halving in h's dtype, erfc in fp32."""
    y = (-h) * _scalar(0.7071067811865476, h.dtype)
    e = torch.special.erfc(y.float()).to(h.dtype)
    return (h * _scalar(0.5, h.dtype)) * e


def decode_stack_plain(pack: Pack, x0, sbias, cbias, self_k, self_v, cross_k, cross_v,
                       cache_index: int, beam_size: int, scaling: float):
    """The plain PyTorch version of K7 (the CPU path and the kernel's reference)."""
    rows, d = x0.shape
    L, _, H, Tmax, hd = self_k.shape
    B, Kb, dt = rows // beam_size, beam_size, x0.dtype
    s = _scalar(scaling, dt)
    idx = int(cache_index)
    k_new = torch.empty((L, rows, d), dtype=dt, device=x0.device)
    v_new = torch.empty_like(k_new)
    later = torch.arange(Tmax, device=x0.device) > idx
    x = x0
    for l in range(L):
        ln, b_misc = pack["ln"][l], pack["b_misc"][l]
        # self attention over the cache, the current position's K/V substituted
        qkv = _dot(_ln(x, ln[0], ln[1]), pack["w_self3"][l]) + pack["b_self3"][l]
        q, kn, vn = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
        k_new[l], v_new[l] = kn, vn
        kc, vc = self_k[l].float(), self_v[l].float()  # [rows, H, Tmax, hd] copies
        kc[:, :, idx] = kn.float().view(rows, H, hd)
        vc[:, :, idx] = vn.float().view(rows, H, hd)
        qf = (q * s).float().view(rows, H, 1, hd)
        w = (qf @ kc.transpose(-1, -2))[:, :, 0] + sbias[l]  # [rows, H, Tmax]
        probs = torch.softmax(w.masked_fill(later, NEG_INF), dim=-1).to(dt)
        o = (probs.float()[:, :, None, :] @ vc)[:, :, 0].to(dt)  # [rows, H, hd]
        x = x + (_dot(o.reshape(rows, d), pack["w_so"][l]) + b_misc[0])
        # beam-shared cross attention: a sample's beams against its K/V
        q2 = (_dot(_ln(x, ln[2], ln[3]), pack["w_cq"][l]) + b_misc[1]) * s
        qb = q2.float().view(B, Kb, H, hd).transpose(1, 2)  # [B, H, Kb, hd]
        w2 = qb @ cross_k[l].float().transpose(-1, -2) + cbias[:, :, None, :]
        p2 = torch.softmax(w2, dim=-1).to(dt)
        o2 = (p2.float() @ cross_v[l].float()).to(dt)  # [B, H, Kb, hd]
        x = x + (_dot(o2.transpose(1, 2).reshape(rows, d), pack["w_co"][l]) + b_misc[2])
        # FFN
        h1 = _dot(_ln(x, ln[4], ln[5]), pack["w_fc1"][l]) + pack["b_fc1"][l]
        x = x + (_dot(_gelu_exact(h1), pack["w_fc2"][l]) + b_misc[3])
    return x, k_new, v_new


def _check_cuda(pack: Pack, x0, sbias, cbias, self_k, self_v, cross_k, cross_v,
                cache_index: int, beam_size: int) -> None:
    name = "decode_stack_step"
    L, _, H, Tmax, hd = self_k.shape
    _build.check_head_dim(name, hd)
    if x0.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x0.device}")
    rows, d = x0.shape
    if d != H * hd:
        raise ValueError(f"{name}: x0's width {d} != {H} heads x {hd}")
    B, S = cross_k.shape[1], cross_k.shape[3]
    f = pack["w_fc1"].shape[1]
    _build.require_cuda(name, {"x0": x0, "self_k": self_k, "self_v": self_v, "cross_k": cross_k,
                               "cross_v": cross_v, **{n: pack[n] for n in _PACK if n != "ln"}},
                        _DTYPES)
    _build.require_cuda(name, {"sbias": sbias, "cbias": cbias, "ln": pack["ln"]}, (torch.float32,))
    if sbias.device != x0.device:
        raise ValueError(f"{name}: all inputs must be on {x0.device}")
    shapes = {"self_v": (self_v, (L, rows, H, Tmax, hd)), "cross_k": (cross_k, (L, B, H, S, hd)),
              "cross_v": (cross_v, (L, B, H, S, hd)), "sbias": (sbias, (L, rows, H, Tmax)),
              "cbias": (cbias, (B, H, S)), "w_self3": (pack["w_self3"], (L, 3 * d, d)),
              "b_self3": (pack["b_self3"], (L, 3 * d)), "w_so": (pack["w_so"], (L, d, d)),
              "w_cq": (pack["w_cq"], (L, d, d)), "w_co": (pack["w_co"], (L, d, d)),
              "w_fc1": (pack["w_fc1"], (L, f, d)), "b_fc1": (pack["b_fc1"], (L, f)),
              "w_fc2": (pack["w_fc2"], (L, d, f)), "b_misc": (pack["b_misc"], (L, 4, d)),
              "ln": (pack["ln"], (L, 6, d))}
    for arg, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} != {shape}")
    if rows != B * beam_size:
        raise ValueError(f"{name}: rows {rows} != {B} samples x {beam_size} beams")
    if not 0 <= cache_index < Tmax:
        raise ValueError(f"{name}: cache_index {cache_index} outside [0, {Tmax})")


def split_plan(dout: int, K: int, rows: int, n_sm: int) -> int:
    """Chunks of 64 per split of a ``[rows, K] x [dout, K]^T`` product on the
    weight-streaming core: as many splits as keep the (row tile, m64 tile,
    split) CTAs within ``n_sm`` SMs (a second CTA on an SM doubles that SM's
    latency-bound epilogue), at most ``MAX_SPLITS``, each split at least one
    chunk and the last split what is left. A split holds at most ``MAX_CPS``
    chunks, so a K deeper than ``MAX_SPLITS * MAX_CPS`` chunks takes
    ``ceil(chunks / MAX_CPS)`` splits, more than ``MAX_SPLITS``."""
    tiles = -(-rows // _build.row_tile(rows)) * -(-dout // 64)
    nch = -(-K // 64)
    splits = min(max(1, n_sm // tiles), MAX_SPLITS, nch)
    return min(MAX_CPS, -(-nch // splits))


def _products(d: int, f: int) -> Dict[str, Tuple[int, int]]:
    """(dout, K) of the q|k|v, d x d, fc1 and fc2 products, in the C call's order."""
    return {"qkv": (3 * d, d), "dd": (d, d), "fc1": (f, d), "fc2": (d, f)}


def tile_width(dp: int) -> int:
    """The columns of the cross-attentions' tiles at instance dp: dp, or on the
    deep route a chunk's (``decode_attn::tile_width``)."""
    return _build.DEEP_CHUNK if dp == _build.DEEP else dp


def cross_stages(dp: int) -> int:
    """The depth of the bf16 cross-attentions' rings of K/V tiles at instance
    dp (``decode_attn::stages``, K6's too): 8 up to 128 and on the deep route,
    then as many as 8 tiles of 128 columns take (5 at 192, 4 at 256)."""
    return 8 if tile_width(dp) <= _build.WIDE_HEAD_DIM else 8 * 128 // dp


def _cross_smem(Kb: int, S: int, D: int = 64) -> int:
    """Shared memory of the bf16 cross-attention's whole-row route at head dim
    D, on its instance DP (``_build.head_instance``; ``decode_attn::smem_bytes``;
    the deep route: 128, its chunks'), for a beam tile of min(Kb, 16) beams:
    the ring of ``cross_stages`` 64 x DP bf16 tiles, the mbarriers, the fp32
    scores and bias row, the bf16 probabilities."""
    kb, sp, dp = min(Kb, BEAM_TILE), -(-S // 64) * 64, tile_width(_build.head_instance(D))
    st = cross_stages(dp)
    return 1024 + st * 128 * dp + 16 * st + 4 * (kb + 1) * sp + 2 * kb * (sp + 8)


def fma_cross_chunk(Kb: int, S: int, D: int, budget: int = _build.SMEM_MAX) -> int:
    """The keys of a score chunk of the fp32 cross-attention (K6's and K7's FMA
    route, ``cross_attn::smem_bytes``) for a beam tile of min(Kb, 16) beams at
    head dim D: S where the whole row fits ``budget`` bytes of shared memory,
    else the most keys, a multiple of 64 and at most ``FMA_CHUNK``, that fit."""
    kb, dp = min(Kb, BEAM_TILE), _build.head_instance(D)
    if dp == _build.DEEP:  # 64 dims of q, the value partials of a 128-column block
        fixed = 4 * (kb * 64 + 2 * kb * _build.DEEP_CHUNK + 2 * kb)
    else:
        fixed = 4 * (kb * dp + (256 // dp) * kb * dp + 2 * kb)
    if fixed + 4 * kb * S <= budget:
        return S
    chunk = min(FMA_CHUNK, (budget - fixed) // (4 * kb) // 64 * 64)
    if chunk < 64:
        raise ValueError(f"cross-attention: {budget} bytes of shared memory hold no score chunk")
    return chunk


def cross_plan(Kb: int, S: int, D: int, fp32: bool, budget: int = _build.SMEM_MAX,
               smem=_cross_smem) -> dict:
    """The route of K7's (or, with K6's ``smem``, K6's) cross-attention at Kb
    beams, S keys and head dim D in ``budget`` bytes of shared memory:
    ``beam_tiles`` CTAs of up to 16 beams per (head, sample), and ``chunk``,
    the keys of a score chunk: S for the whole-row route (the scores of a
    row in shared memory: one pass over K, an exact softmax), fewer for the
    score-chunked route (a first pass over K for each row's max and sum, a
    second for the probabilities and the values; the bf16 route chunks by
    its 64-key tiles)."""
    if fp32:
        chunk = fma_cross_chunk(Kb, S, D, budget)
    else:
        chunk = S if smem(Kb, S, D) <= budget else 64
    return {"beam_tiles": -(-Kb // BEAM_TILE), "chunk": chunk}


def stack_plan(beam_size: int, S: int, Tmax: int, cache_index: int, d: int, H: int, fp32: bool,
               budget: int = _build.SMEM_MAX, sa_chunk: int = SA_CHUNK) -> dict:
    """The routes a K7 step takes: the cross-attention's (``cross_plan``);
    ``cache_chunked`` where the self-attention's positions run past its
    chunk of ``sa_chunk`` positions (the kernels': ``SA_CHUNK``; its later
    positions' scores computed again, a chunk of probabilities at a time);
    ``ragged`` where d is not a multiple of 64 (the products' last 64-deep
    chunk zero-filled and last 64-row tile masked on store, the LayerNorm's
    row statistics over ceil(d / 64) tiles)."""
    return dict(cross_plan(beam_size, S, d // H, fp32, budget),
                cache_chunked=cache_index >= min(Tmax, sa_chunk), ragged=d % 64 != 0)


def _run_sm90(pack: Pack, x0, sbias, cbias, self_k, self_v, cross_k, cross_v, cache_index: int,
              beam_size: int, scaling: float, out, pdl: bool = True) -> None:
    """The bf16 route's one C call, on caches whose rows are the head dim
    ``x0.shape[1] / H`` rounded up to a multiple of 8 (``_build.pad_head``).
    Its products and cross-attention start with programmatic dependent
    launch (their weight and K/V copies overlap the previous launch's tail);
    ``pdl=False`` serialises them, so that a profile can split the step's
    device time by kernel."""
    rows, d = x0.shape
    L, _, H, Tmax, _ = self_k.shape
    hd = d // H
    B, S = cross_k.shape[1], cross_k.shape[3]
    f = pack["w_fc1"].shape[1]
    chunked = cross_plan(beam_size, S, hd, fp32=False)["chunk"] < S
    n_sm, n_tile = _build.sm_count(x0.device), _build.row_tile(rows)
    rtiles = -(-rows // n_tile)
    cps, part_elems, tiles = [], 1, 1
    for dout, K in _products(d, f).values():
        c = split_plan(dout, K, rows, n_sm)
        cps.append(c)
        nch = -(-K // 64)
        mtiles, splits = -(-dout // 64), -(-nch // c)
        tiles = max(tiles, rtiles * mtiles)
        part_elems = max(part_elems, rtiles * mtiles * splits * 64 * n_tile)
    dev = x0.device
    scratch = torch.empty(rows * (3 * d + f), dtype=x0.dtype, device=dev)
    part = torch.empty(part_elems, dtype=torch.float32, device=dev)
    counters = torch.zeros(tiles, dtype=torch.int32, device=dev)
    stats = torch.empty((-(-d // 64), rows, 2), dtype=torch.float32, device=dev)
    x_out, k_new, v_new = out
    fn = _build.kernel_function("mk_decode_stack_step_sm90", _SIG_SM90)
    with torch.cuda.device(dev):
        err = fn(
            *(pack[n].data_ptr() for n in _PACK), x0.data_ptr(), sbias.data_ptr(),
            cbias.data_ptr(), self_k.data_ptr(), self_v.data_ptr(), cross_k.data_ptr(),
            cross_v.data_ptr(), x_out.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            scratch.data_ptr(), part.data_ptr(), counters.data_ptr(), stats.data_ptr(),
            L, B, beam_size, H, S, Tmax, f, int(cache_index), _scalar(scaling, x0.dtype),
            n_tile, *cps, int(pdl), hd, int(chunked), _build.stream_of(x0))
    _build.check(err, "decode_stack_step")


def decode_stack_step(
    pack: Pack,
    x0: torch.Tensor,       # [rows, d] compute-dtype decoder input of this step
    sbias: torch.Tensor,    # [L, rows, H, Tmax] fp32 self bias + rel of this step
    cbias: torch.Tensor,    # [B, H, S] fp32 cross bias row, pads folded to −1e9
    self_k: torch.Tensor,   # [L, rows, H, Tmax, hd] (read only)
    self_v: torch.Tensor,
    cross_k: torch.Tensor,  # [L, B, H, S, hd] compute dtype
    cross_v: torch.Tensor,
    cache_index: int,
    beam_size: int,
    scaling: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (x_out [rows, d], k_new, v_new [L, rows, d]). The plain version for CPU
    tensors; on CUDA the tensor-core kernels for bf16, the FMA kernels for fp32."""
    args = (pack, x0, sbias, cbias, self_k, self_v, cross_k, cross_v)
    if x0.device.type == "cpu":
        return decode_stack_plain(*args, cache_index, beam_size, scaling)
    _check_cuda(*args, cache_index, beam_size)
    hd = self_k.shape[-1]
    # a head dim that is not a multiple of 8: zero-padded copies of the caches
    self_k, self_v, cross_k, cross_v = (_build.pad_head(c) for c in (self_k, self_v, cross_k,
                                                                      cross_v))
    args = (pack, x0, sbias, cbias, self_k, self_v, cross_k, cross_v)
    bf16_tensors = {"x0": x0, "self_k": self_k, "self_v": self_v, "cross_k": cross_k,
                    "cross_v": cross_v, **{n: pack[n] for n in _PACK if n != "ln"}}
    kind = _build.route("decode_stack_step", x0.device, x0.dtype, bf16_tensors)
    rows, d = x0.shape
    L, _, H, Tmax, _ = self_k.shape
    B, S = cross_k.shape[1], cross_k.shape[3]
    f = pack["w_fc1"].shape[1]
    dt = x0.dtype
    x_out = torch.empty_like(x0)
    k_new = torch.empty((L, rows, d), dtype=dt, device=x0.device)
    v_new = torch.empty_like(k_new)
    plan = stack_plan(beam_size, S, Tmax, cache_index, d, H, fp32=kind != "sm90")
    if kind == "sm90":
        _run_sm90(*args, cache_index, beam_size, scaling, (x_out, k_new, v_new))
        decode_stack_step.launches_sm90 += 1
    else:
        scratch = torch.empty(rows * (3 * d + f), dtype=dt, device=x0.device)
        fn = _build.kernel_function("mk_decode_stack_step", _SIG)
        with torch.cuda.device(x0.device):
            err = fn(
                *(pack[n].data_ptr() for n in _PACK),
                x0.data_ptr(), sbias.data_ptr(), cbias.data_ptr(), self_k.data_ptr(),
                self_v.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(), x_out.data_ptr(),
                k_new.data_ptr(), v_new.data_ptr(), scratch.data_ptr(),
                L, B, beam_size, H, S, Tmax, f, int(cache_index), _scalar(scaling, dt), hd,
                plan["chunk"], _build.stream_of(x0),
            )
        _build.check(err, "decode_stack_step")
    decode_stack_step.launches += 1
    decode_stack_step.padded += self_k.shape[-1] != hd
    decode_stack_step.wide += _build.head_instance(hd) > _build.WIDE_HEAD_DIM
    decode_stack_step.deep += _build.head_instance(hd) == _build.DEEP
    decode_stack_step.beam_tiled += plan["beam_tiles"] > 1
    decode_stack_step.chunked += plan["chunk"] < S
    decode_stack_step.cache_chunked += plan["cache_chunked"]
    decode_stack_step.ragged += plan["ragged"]
    return x_out, k_new, v_new


decode_stack_step.launches = 0  # K7, either route
decode_stack_step.launches_sm90 = 0  # K7 on the tensor-core route (bf16)
decode_stack_step.padded = 0  # the launches that ran on zero-padded caches
decode_stack_step.wide = 0  # the launches on an instance past 128 (cross_stages, q in shared memory)
decode_stack_step.deep = 0  # the launches on the deep route (D > 256)
# the launches that ran a route of stack_plan: more than 16 beams (beam tiles),
# the cross scores in chunks, the self cache past SA_CHUNK, d % 64 != 0
decode_stack_step.beam_tiled = 0
decode_stack_step.chunked = 0
decode_stack_step.cache_chunked = 0
decode_stack_step.ragged = 0
