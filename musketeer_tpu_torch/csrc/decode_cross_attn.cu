// K6: one decode step of beam-shared cross-attention over the int8 K/V
// cache, for sm_90a.
//
// Replaces the Pallas kernel musketeer_tpu/ops/decode_cross_attn.py::
// decode_cross_attention_int8 (_kernel; pallas_call at :94). For each
// (sample, head) and the sample's Kb beams:
//   w = (q . k_i8^T) * k_scale + bias, pads -> -1e9, max clamped at -1e8,
//   p = e / max(sum e, 1e-38) * v_scale, out = round(p) . v_i8   (q's dtype)
// so a fully padded sample gives exact zeros. The 1e-38 floor is subnormal:
// the library is built without --use_fast_math, so it is not flushed.
//
// Translation. The TPU kernel runs one grid cell per sample with all H
// heads of its [H, S, D] int8 K/V in VMEM and one batched dot. Here one
// block owns one (head, sample) and reads that head's int8 K and V once for
// all Kb beams.
//
// Bound. At the caption decode shape (B16 H12 Kb5 S908 D64) a call must
// read 2 x 11.2 MB of int8 K/V plus 2 x 0.7 MB of scales and the bias row:
// ~24 MB, 7 us at 3.35 TB/s; its 2 x 0.45 G multiply-adds are under 1 us on
// the tensor cores. It is bound by the bytes. At ofa_huge's (B16 H16 Kb5
// S908 D80) ~40 MB, 12 us.
//
// bf16 q (mk_decode_cross_attn_int8_sm90) runs on the tensor cores, in
// K7's cross-attention layout (decode_attn_sm90.cuh) with the int8 cache;
// the tile width DP is a template parameter, compiled at 32, 64, 80, 128, 192
// and 256 (a head dim D, a multiple of 16 here, runs on the smallest DP >=
// D; the wrapper copies any other into a zero-padded cache first):
//   - one CTA per (h, b, beam tile of up to 16 beams): a producer warp
//     streams TMA tiles of 64 keys x DP
//     int8 (4 KB at DP 64, 8 KB at 128, 16 KB at 256, unswizzled; the map
//     spans the true D, so the bytes past D are zeros) through a ring of
//     K7's depth (decode_attn::stages: 8 up to DP 128, 5 at 192, 4 at 256),
//     K then V; 8 consumer warps;
//   - scores: lane (g, t) of warp w loads key 8 w + g's bytes DP / 4 t ..
//     DP / 4 (t + 1) - 1 once (16-byte loads where DP / 4 is a multiple of
//     16: one at DP 64, two at 128, three at 192, four at 256,
//     conflict-free as the rows lie; one 8-byte load at DP 32; five 4-byte
//     loads at DP 80, whose 80-byte rows are not 16-byte pieces per lane)
//     and widens them exactly
//     (sm90::widen_i8x4) into its mma.sync B fragments, word j for k-step j
//     (DP / 16 of them). That permutes the DP dims inside the product (k-slot
//     16 j + s is dim DP / 4 t + 4 j + e, t = (s % 8) / 2, e = s % 2 + 2 (s /
//     8)); q's A fragments are loaded in the same permutation (zeros past D),
//     so every product is unchanged. w = acc * k_scale + bias with both rows
//     staged once and the pads folded in (k_scale 0, bias -1e9: w is -1e9
//     exactly);
//   - softmax: one warp per beam row, clamped and floored, e kept from the
//     sum's pass, p = e / l * v_scale rounded to bf16;
//   - P.v: the threads widen the value tile into a bf16 tile (two,
//     alternating: one barrier a tile; in K7's layout, sm90.cuh::HeadTile),
//     read by ldmatrix.trans as K7's: warp w owns the n8 column blocks
//     w + 8 n < DP / 8; the columns past D are stored nowhere.
// Past the whole row's fit (16 beams at S ~1660, 5 at ~4290), the
// score-chunked route (kChunked) takes K7's two passes (decode_attn_sm90.cuh):
// each row's max (from -1e8: the clamp) and sum over the K tiles, then per
// tile the scores again, p = e / max(l, 1e-38) * v_scale into one of two P
// tiles, the value tile widened, P.v; the scale, bias and pad rows are read
// a tile at a time from global memory.
// Shared memory ~89 KB at Kb 5, S 908, D 64 (~101 KB at D 80): two CTAs an
// SM, so the 192 (h, b) CTAs of the ofa_base serving shape (256 at
// ofa_huge's) run in one wave on 132 SMs; ~137 KB at DP 128, one CTA an SM
// (96 CTAs at 6 heads of 128), ~149 KB at 192 and ~169 KB at 256 (64 and 48
// CTAs at ofa_base's width), where the CTA may take up to 224 registers
// (q's fragments alone are DP / 4 a thread: 86 and 106 registers whole-row,
// 143 and 152 chunked). ptxas (CUDA 12.8): no spills at
// any instance; where D == DP the compiler knows D (kExact), which at DP 80
// halved the kernel's time against D read at run time. Launched with
// programmatic stream serialization: the K/V copies start before the kernel
// waits on the previous kernel; q, the bias, the scales and the pads are
// read after the wait.
//
// Past 256 (the deep route, any D a multiple of 16): 64 x 128 int8 tiles on
// the instance 128's ring of 8; a key tile's score sums its ceil(D / 128)
// chunk tiles' products, q's fragments of each chunk loaded as it comes, and
// a CTA owns one 128-column block of the output (grid z = beam tiles x
// blocks), so at 1 head of 768 the 16 (h, b) pairs of the serving shape
// make 96 CTAs; each block reads the sample's K tiles again (mostly from
// L2). ptxas (CUDA 12.8): 72 registers, 109 chunked, no spills.
//
// fp32 q (mk_decode_cross_attn_int8) stays on the FMA kernel of
// cross_attn.cuh: 256 threads, one key row a thread, widened in registers,
// fp32 scores, softmax and value sums.
#include <stdint.h>

#include "common.cuh"
#include "cross_attn.cuh"
#include "decode_attn_sm90.cuh"  // K7's tile layout (unit_addr)
#include "sm90.cuh"

namespace {

namespace sm90 = mk::sm90;
using bf16 = __nv_bfloat16;
using sm90::mma16816;
using sm90::swz;

constexpr int BKT = 64;                 // keys per tile
constexpr int NC = 256;                 // consumer threads: 8 warps
constexpr int NT = NC + 32;             // + the producer warp
constexpr int MAX_KB = 16;              // beams of a tile: one m16 A tile
constexpr int PT = BKT + 8;             // a chunked P tile's row stride (bf16)
constexpr float NEG_BIAS = -1e9f;       // the score of a padded key

template <int DP>
struct Tiles {
  static constexpr int W = DP == mk::DEEP ? mk::DEEP_CHUNK : DP;  // a tile's columns (deep: a chunk's)
  static constexpr int STAGES = mk::decode_attn::stages<W>();  // ring depth, as K7's
  static constexpr uint32_t KV = BKT * W;                    // one 64 x W int8 K or V tile
  static constexpr uint32_t V16 = sm90::HeadTile<W>::BYTES;  // one 64 x W bf16 value tile
};

struct Args {
  const bf16* q;          // [B, H, Kb, D]
  const float* k_scale;   // [B, H, S]
  const float* v_scale;   // [B, H, S]
  const float* bias;      // element (b, h, s) at b * bias_bs + h * bias_hs + s
  const uint8_t* pad;     // [B, S] bool
  bf16* out;              // [B, H, Kb, D]
  int H, Kb, S, D;
  long long bias_bs, bias_hs;
};

// the whole-row route at Kb beams of a tile: the ring, two bf16 value tiles,
// the mbarriers, the fp32 scores [Kb][S'] and the k_scale, v_scale and bias
// rows, the bf16 probabilities [Kb][S' + 8] (S' = S rounded up to 64)
template <int DP>
inline size_t smem_bytes(int Kb, int S) {
  const int sp = (S + BKT - 1) / BKT * BKT;
  constexpr int STAGES = Tiles<DP>::STAGES;
  return 1024 + STAGES * Tiles<DP>::KV + 2 * Tiles<DP>::V16 + 16 * STAGES +
         sizeof(float) * ((size_t)Kb * sp + 3 * (size_t)sp) + 2 * (size_t)Kb * (sp + 8);
}

// the score-chunked route, at any S: the ring, two bf16 value tiles, the
// mbarriers, two bf16 P tiles [16][PT], the warps' row maxes and sums
template <int DP>
constexpr size_t smem_bytes_chunked() {
  constexpr int STAGES = Tiles<DP>::STAGES;
  return 1024 + STAGES * Tiles<DP>::KV + 2 * Tiles<DP>::V16 + 16 * STAGES +
         2 * 2 * MAX_KB * PT + sizeof(float) * 2 * (NC / 32) * MAX_KB;
}

// kmap, vmap: this layer's cache [B * H, S, D] int8 with 64 x DP boxes.
// kExact: D == DP, known to the compiler. kChunked: the score-chunked route.
// Block z is the beam tile: beams 16 z .. 16 z + 15 of the sample.
// The deep route (DP == DEEP, D past 256): the tiles are 64 x 128 chunks
// (W = 128, the instance 128's layout); each key tile's score is the sum of
// its nk = D / 128 chunk tiles' products, q's fragments of each chunk loaded
// as it comes (scores_deep), and the CTA owns one 128-column block of v and
// the output (block z = beam tile x nk + block), whose value tiles alone
// it streams.
template <int DP, bool kExact, bool kChunked>
__global__ void __launch_bounds__(NT, DP <= 128 && DP != mk::DEEP ? 2 : 1)
    cross_attn_i8_sm90_kernel(const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap, Args a) {
  constexpr bool kDeep = DP == mk::DEEP;
  constexpr int W = Tiles<DP>::W;  // a tile's columns
  using HT = sm90::HeadTile<W>;
  constexpr int STAGES = Tiles<DP>::STAGES;
  constexpr uint32_t KV_TILE = Tiles<DP>::KV, TILE = Tiles<DP>::V16;
  constexpr int NB = (W / 8 + 7) / 8;  // n8 column blocks a warp owns in P.v
  const int D = kExact ? DP : a.D;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t vt = base + STAGES * KV_TILE;  // two bf16 value tiles
  const uint32_t bars = vt + 2 * TILE;
  const int nk = kDeep ? mk::deep_chunks(a.D) : 1;  // the deep route's chunks (and blocks)
  const int h = blockIdx.x, b = blockIdx.y, j0 = MAX_KB * (blockIdx.z / nk), S = a.S;
  const int cb = blockIdx.z % nk, c0 = W * cb;  // the deep route's block of v and the output
  const int Kb = min(MAX_KB, a.Kb - j0);  // this tile's beams
  const int ntiles = (S + BKT - 1) / BKT, sp = ntiles * BKT;
  const int pst = kChunked ? PT : sp + 8;  // a probability row's stride
  // the whole-row route: scores, the scale and bias rows, P [Kb][pst]; the
  // chunked route: two P tiles [16][PT], the warps' row maxes and sums
  float* sc = reinterpret_cast<float*>(smem_raw + (bars + 16 * STAGES - raw));  // [Kb][sp]
  float* ks = sc + (size_t)Kb * sp;  // [sp] k_scale, 0 at pads
  float* vs = ks + sp;               // [sp] v_scale
  float* bias = vs + sp;             // [sp] the bias row, -1e9 at pads
  bf16* P = kChunked ? reinterpret_cast<bf16*>(sc) : reinterpret_cast<bf16*>(bias + sp);
  float* part = reinterpret_cast<float*>(P + 2 * MAX_KB * PT);  // [8][16][2]
  auto full = [=](int st) { return bars + 8u * st; };
  auto empty = [=](int st) { return bars + 8u * (STAGES + st); };
  auto stage = [=](int st) { return smem_raw + (base + KV_TILE * st - raw); };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(empty(st), NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  sm90::launch_dependents();

  const long long bh = (long long)b * a.H + h;
  if (tid >= NC) {  // the producer warp: K tiles, then V tiles (chunked: K, then K V K V ..)
    if (kDeep && tid == NC) {  // each K tile as nk chunks; V: the block's columns
      int seq = 0;
      auto put = [&](const CUtensorMap* map, int col, int row) {
        const int st = seq % STAGES;
        if (seq >= STAGES) sm90::mbar_wait(empty(st), (seq / STAGES - 1) & 1);
        sm90::mbar_expect_tx(full(st), KV_TILE);
        sm90::tma_load3(base + KV_TILE * st, map, full(st), col, row, (int)bh);
        ++seq;
      };
      for (int it = 0; it < ntiles; ++it)
        for (int c = 0; c < nk; ++c) put(&kmap, W * c, it * BKT);
      for (int it = 0; it < ntiles; ++it) {
        if (kChunked)
          for (int c = 0; c < nk; ++c) put(&kmap, W * c, it * BKT);
        put(&vmap, c0, it * BKT);
      }
    } else if (tid == NC) {
      const int total = (kChunked ? 3 : 2) * ntiles;
      for (int it = 0; it < total; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) sm90::mbar_wait(empty(st), (it / STAGES - 1) & 1);
        const bool value = !kChunked ? it >= ntiles : it >= ntiles && (it - ntiles) % 2 == 1;
        const int row = (!kChunked || it < ntiles ? it % ntiles : (it - ntiles) / 2) * BKT;
        sm90::mbar_expect_tx(full(st), KV_TILE);
        sm90::tma_load3(base + KV_TILE * st, value ? &vmap : &kmap, full(st), 0, row, (int)bh);
      }
    }
    return;  // no block-wide barrier follows
  }

  sm90::grid_wait();  // q and the bias row may be the previous kernel's
  const float* bias_row = a.bias + (long long)b * a.bias_bs + h * a.bias_hs;
  const uint8_t* pad = a.pad + (long long)b * S;
  if constexpr (!kChunked) {
    // the scale and bias rows, the pads folded in; zeros past S
    for (int s = tid; s < sp; s += NC) {
      float k_s = 0.f, v_s = 0.f, bi = 0.f;
      if (s < S) {
        const bool padded = pad[s] != 0;
        k_s = padded ? 0.f : a.k_scale[bh * S + s];
        v_s = a.v_scale[bh * S + s];
        bi = padded ? NEG_BIAS : bias_row[s];
      }
      ks[s] = k_s;
      vs[s] = v_s;
      bias[s] = bi;
    }
  }
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // q's A fragments in the permuted dim order of the K fragments: k-step j,
  // rows g and g + 8 (beams), dims W / 4 t + 4 j .. + 3 (zeros past D)
  uint32_t qa[W / 16][4];
  const bf16* qrow = a.q + (bh * a.Kb + j0) * D;
  // the A fragments of dims e0 + .. (the deep route: chunk e0 / 128's)
  auto load_qa = [&](int e0) {
    const bf16* q = qrow + e0;
    auto quad = [&](int j, int c) -> uint2 {
      return j < Kb && e0 + c < D ? *reinterpret_cast<const uint2*>(q + j * D + c)
                                  : make_uint2(0u, 0u);
    };
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      const uint2 lo = quad(g, W / 4 * t + 4 * kk), hi = quad(g + 8, W / 4 * t + 4 * kk);
      qa[kk][0] = lo.x;
      qa[kk][1] = hi.x;
      qa[kk][2] = lo.y;
      qa[kk][3] = hi.y;
    }
  };
  if constexpr (!kDeep) load_qa(0);
  sm90::named_sync(1, NC);  // the rows

  // the dots of keys 8 warp .. + 7 of the K tile in stage st (releases the
  // stage); with acc, added to c. The deep route releases a stage after a
  // proxy fence (sm90::fence_async_smem): its ring turns over a chunk at a
  // time, and without the fence the next TMA copy into a stage overtook some
  // lanes' generic reads of it (other chunks' and V's bytes in some beams'
  // scores, run to run, on an H100).
  auto scores = [&](int st, float (&c)[4], bool acc = false) {
    const uint8_t* krow = stage(st) + (8 * warp + g) * W + W / 4 * t;
    uint32_t words[W / 16];
    if constexpr ((W / 4) % 16 == 0) {  // 16-byte pieces
#pragma unroll
      for (int i = 0; i < W / 64; ++i) {
        const uint4 kw = *reinterpret_cast<const uint4*>(krow + 16 * i);
        words[4 * i] = kw.x;
        words[4 * i + 1] = kw.y;
        words[4 * i + 2] = kw.z;
        words[4 * i + 3] = kw.w;
      }
    } else if constexpr ((W / 4) % 8 == 0) {  // 8-byte pieces
#pragma unroll
      for (int i = 0; i < W / 32; ++i) {
        const uint2 kw = *reinterpret_cast<const uint2*>(krow + 8 * i);
        words[2 * i] = kw.x;
        words[2 * i + 1] = kw.y;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        words[kk] = *reinterpret_cast<const uint32_t*>(krow + 4 * kk);
    }
    uint32_t kb[W / 16][2];
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) sm90::widen_i8x4(words[kk], kb[kk][0], kb[kk][1]);
    if constexpr (!kDeep) sm90::mbar_arrive(empty(st));
    if (!acc) c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) mma16816(c, qa[kk], kb[kk][0], kb[kk][1]);
    if constexpr (kDeep) {
      sm90::fence_async_smem();
      sm90::mbar_arrive(empty(st));
    }
  };
  // the deep route's ring, as the consumers walk it: the next tile's stage
  int seq = 0;
  auto take = [&]() {
    const int st = seq % STAGES;
    sm90::mbar_wait(full(st), (seq / STAGES) & 1);
    ++seq;
    return st;
  };
  // the deep route's dots of a key tile: its nk chunks in order, q's
  // fragments of each loaded as it comes
  auto scores_deep = [&](float (&c)[4]) {
    for (int ch = 0; ch < nk; ++ch) {
      const int st = take();
      load_qa(W * ch);
      scores(st, c, ch > 0);
    }
  };
  // the value tile in stage st widened into the bf16 tile at vb (key-major
  // rows in K7's swizzled layout; releases the stage: on the deep route once
  // the widened words are stored, behind the proxy fence, as the scores')
  auto widen_v = [&](int st, uint32_t vb) {
    uint8_t* row = smem_raw + (vb - raw);
    if constexpr (W == 64) {  // thread tid: key tid / 4, dims 16 (tid % 4) .. + 15
      const uint4 vw = *reinterpret_cast<const uint4*>(stage(st) + 16 * tid);
      const uint32_t words[4] = {vw.x, vw.y, vw.z, vw.w};
      uint32_t wv[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) sm90::widen_i8x4(words[k], wv[2 * k], wv[2 * k + 1]);
      sm90::mbar_arrive(empty(st));
      const int key = tid / 4, u = 2 * (tid % 4);
      *reinterpret_cast<uint4*>(row + swz(key, u)) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      *reinterpret_cast<uint4*>(row + swz(key, u + 1)) = make_uint4(wv[4], wv[5], wv[6], wv[7]);
    } else {  // 8-byte pieces: piece i is key i / (W / 8), dims 8 (i % (W / 8)) .. + 7
      constexpr int PIECES = BKT * W / 8, PER = (PIECES + NC - 1) / NC;
      uint2 vw[PER];
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const int i = tid + r * NC;
        vw[r] = i < PIECES ? *reinterpret_cast<const uint2*>(stage(st) + 8 * i) : make_uint2(0, 0);
      }
      if constexpr (!kDeep) sm90::mbar_arrive(empty(st));
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const int i = tid + r * NC;
        if (i >= PIECES) continue;
        uint32_t w0, w1, w2, w3;
        sm90::widen_i8x4(vw[r].x, w0, w1);
        sm90::widen_i8x4(vw[r].y, w2, w3);
        *reinterpret_cast<uint4*>(row + (HT::unit(vb, i / (W / 8), i % (W / 8)) - vb)) =
            make_uint4(w0, w1, w2, w3);
      }
      if constexpr (kDeep) {
        sm90::fence_async_smem();
        sm90::mbar_arrive(empty(st));
      }
    }
  };
  // o += P (rows g, g + 8; columns k0 .. k0 + 63) . the bf16 value tile at vb
  float o[NB][4] = {};
  auto pv = [&](uint32_t vb, const bf16* Pt, int k0) {
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      const int kc = k0 + 16 * kq + 2 * t;  // this lane's A columns kc, kc + 1 (and + 8)
      uint32_t pa[4];
      const bf16* p0 = Pt + (size_t)g * pst + kc;
      const bf16* p1 = Pt + (size_t)(g + 8) * pst + kc;
      pa[0] = g < Kb ? *reinterpret_cast<const uint32_t*>(p0) : 0u;
      pa[1] = g + 8 < Kb ? *reinterpret_cast<const uint32_t*>(p1) : 0u;
      pa[2] = g < Kb ? *reinterpret_cast<const uint32_t*>(p0 + 8) : 0u;
      pa[3] = g + 8 < Kb ? *reinterpret_cast<const uint32_t*>(p1 + 8) : 0u;
      const int key = 16 * kq + (lane % 8) + 8 * ((lane / 8) & 1);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (warp + 8 * n >= W / 8) continue;
        const uint32_t addr = HT::unit(vb, key, warp + 8 * n);
        uint32_t r0, r1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(r0), "=r"(r1)
                     : "r"(addr)
                     : "memory");
        mma16816(o[n], pa, r0, r1);
      }
    }
  };

  if constexpr (!kChunked) {
    // scores: warp w, keys 8 w .. 8 w + 7 of each tile
    for (int it = 0; it < ntiles; ++it) {
      float c[4];
      if constexpr (kDeep) {
        scores_deep(c);
      } else {
        const int st = it % STAGES;
        sm90::mbar_wait(full(st), (it / STAGES) & 1);
        scores(st, c);
      }
      const int s = it * BKT + 8 * warp + 2 * t;  // columns s, s + 1
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (s + e >= S) continue;
        if (g < Kb) sc[(size_t)g * sp + s + e] = c[e] * ks[s + e] + bias[s + e];
        if (g + 8 < Kb) sc[(size_t)(g + 8) * sp + s + e] = c[2 + e] * ks[s + e] + bias[s + e];
      }
    }
    sm90::named_sync(1, NC);

    // softmax, one warp per beam row: the max clamped at -1e8, the sum floored
    // at 1e-38 (subnormal, kept: no flush to zero), p = e / l * v_scale rounded
    // to bf16, zeros past S
    for (int j = warp; j < Kb; j += NC / 32) {
      float* row = sc + (size_t)j * sp;
      float m = -CUDART_INF_F;
      for (int s = lane; s < S; s += 32) m = fmaxf(m, row[s]);
      m = fmaxf(mk::warp_max(m), -1e8f);
      float l = 0.f;
      for (int s = lane; s < S; s += 32) {
        const float e = expf(row[s] - m);
        row[s] = e;
        l += e;
      }
      l = fmaxf(mk::warp_sum(l), 1e-38f);
      bf16* pr = P + (size_t)j * pst;
      for (int s = lane; s < sp; s += 32)
        pr[s] = __float2bfloat16_rn(s < S ? row[s] / l * vs[s] : 0.f);
    }
    sm90::named_sync(1, NC);

    // P.v: each value tile widened into a bf16 tile, then read as K7's; warp w
    // owns the n8 column blocks w + 8 n < W / 8
    for (int it = ntiles; it < 2 * ntiles; ++it) {
      const uint32_t vb = vt + TILE * ((it - ntiles) & 1);
      int st;
      if constexpr (kDeep) {
        st = take();
      } else {
        st = it % STAGES;
        sm90::mbar_wait(full(st), (it / STAGES) & 1);
      }
      widen_v(st, vb);
      // the tile complete; the other tile's readers have passed this barrier
      // before this one is written again
      sm90::named_sync(1, NC);
      pv(vb, P, (it - ntiles) * BKT);
    }
  } else {
    // a key's score w = dot * k_scale + bias, the pads folded in (k_scale 0, bias -1e9)
    auto key_w = [&](float dot, int s) {
      const bool padded = pad[s] != 0;
      const float k_s = padded ? 0.f : __ldg(a.k_scale + bh * S + s);
      const float bi = padded ? NEG_BIAS : __ldg(bias_row + s);
      return dot * k_s + bi;
    };
    // pass 1: each row's max (from -1e8: the clamp) and sum of exp over the K
    // tiles, a key at a time in the lane, then the lanes of a quad, then the warps
    float m[2] = {-1e8f, -1e8f}, l[2] = {0.f, 0.f};  // rows g, g + 8
    for (int it = 0; it < ntiles; ++it) {
      float c[4];
      if constexpr (kDeep) {
        scores_deep(c);
      } else {
        const int st = it % STAGES;
        sm90::mbar_wait(full(st), (it / STAGES) & 1);
        scores(st, c);
      }
      const int s = it * BKT + 8 * warp + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (s + e >= S) continue;
        mk::softmax_merge(m[0], l[0], key_w(c[e], s + e), 1.f);
        mk::softmax_merge(m[1], l[1], key_w(c[2 + e], s + e), 1.f);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off *= 2)
        mk::softmax_merge(m[r], l[r], __shfl_xor_sync(0xffffffffu, m[r], off),
                          __shfl_xor_sync(0xffffffffu, l[r], off));
      if (t == 0) {
        part[2 * (warp * MAX_KB + g + 8 * r)] = m[r];
        part[2 * (warp * MAX_KB + g + 8 * r) + 1] = l[r];
      }
    }
    sm90::named_sync(1, NC);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -1e8f;
      l[r] = 0.f;
      for (int w = 0; w < NC / 32; ++w)
        mk::softmax_merge(m[r], l[r], part[2 * (w * MAX_KB + g + 8 * r)],
                          part[2 * (w * MAX_KB + g + 8 * r) + 1]);
      l[r] = fmaxf(l[r], 1e-38f);  // subnormal, kept
    }
    // pass 2: per tile, the scores again, p = exp(w - m) / l * v_scale rounded
    // to bf16 into a P tile, the value tile widened (two of each, alternating:
    // one barrier a tile), then P.v
    for (int i = 0; i < ntiles; ++i) {
      const int it = ntiles + 2 * i;
      float c[4];
      if constexpr (kDeep) {
        scores_deep(c);
      } else {
        const int st = it % STAGES;
        sm90::mbar_wait(full(st), (it / STAGES) & 1);
        scores(st, c);
      }
      bf16* Pt = P + (i & 1) * MAX_KB * PT;
      const int col = 8 * warp + 2 * t, s = i * BKT + col;
      float p[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = s + e < S;
        const float v_s = live ? __ldg(a.v_scale + bh * S + s + e) : 0.f;
        p[0][e] = live && g < Kb ? expf(key_w(c[e], s + e) - m[0]) / l[0] * v_s : 0.f;
        p[1][e] = live && g + 8 < Kb ? expf(key_w(c[2 + e], s + e) - m[1]) / l[1] * v_s : 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(Pt + g * PT + col) =
          __floats2bfloat162_rn(p[0][0], p[0][1]);
      *reinterpret_cast<__nv_bfloat162*>(Pt + (g + 8) * PT + col) =
          __floats2bfloat162_rn(p[1][0], p[1][1]);
      const uint32_t vb = vt + TILE * (i & 1);
      int sv;
      if constexpr (kDeep) {
        sv = take();
      } else {
        sv = (it + 1) % STAGES;
        sm90::mbar_wait(full(sv), ((it + 1) / STAGES) & 1);
      }
      widen_v(sv, vb);
      sm90::named_sync(1, NC);
      pv(vb, Pt, 0);
    }
  }

  bf16* out = a.out + (bh * a.Kb + j0) * D;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int c = c0 + 8 * (warp + 8 * n) + 2 * t;
    if (warp + 8 * n >= W / 8 || c >= D) continue;
    if (g < Kb)
      *reinterpret_cast<__nv_bfloat162*>(out + g * D + c) =
          __floats2bfloat162_rn(o[n][0], o[n][1]);
    if (g + 8 < Kb)
      *reinterpret_cast<__nv_bfloat162*>(out + (g + 8) * D + c) =
          __floats2bfloat162_rn(o[n][2], o[n][3]);
  }
}

// One layer's cache [B * H, S, D] int8 with 64 x DP boxes, unswizzled (the
// bytes of a box past D zeros).
template <int DP>
inline int cache_map(CUtensorMap* map, const void* ptr, long long bh, int S, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D, (cuuint64_t)S * D};
  const cuuint32_t box[3] = {(cuuint32_t)DP, (cuuint32_t)BKT, 1};
  return sm90::tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, 3, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int DP, bool kExact, bool kChunked>
inline int launch_one(const CUtensorMap& kmap, const CUtensorMap& vmap, const Args& a, int B,
                      size_t smem, cudaStream_t stream) {
  static mk::SmemOptIn opt_in;
  if (const int err =
          opt_in.ensure((const void*)cross_attn_i8_sm90_kernel<DP, kExact, kChunked>, smem))
    return err;
  cudaLaunchConfig_t cfg = {};
  const int nk = DP == mk::DEEP ? mk::deep_chunks(a.D) : 1;  // the deep route's column blocks
  cfg.gridDim = dim3(a.H, B, (a.Kb + MAX_KB - 1) / MAX_KB * nk);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, cross_attn_i8_sm90_kernel<DP, kExact, kChunked>, kmap, vmap, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// grid (H, B, beam tiles), always with programmatic stream serialization;
// chunked: the score-chunked route, else the whole-row route, which must
// fit. A cudaError_t code.
template <int DP>
inline int launch_sm90(const CUtensorMap& kmap, const CUtensorMap& vmap, const Args& a, int B,
                       int chunked, cudaStream_t stream) {
  const size_t smem =
      chunked ? smem_bytes_chunked<DP>() : smem_bytes<DP>(a.Kb < MAX_KB ? a.Kb : MAX_KB, a.S);
  if (a.Kb < 1 || smem > 232448) return (int)cudaErrorInvalidValue;
  if constexpr (DP == mk::DEEP) {  // D is never the instance's
    return chunked ? launch_one<DP, false, true>(kmap, vmap, a, B, smem, stream)
                   : launch_one<DP, false, false>(kmap, vmap, a, B, smem, stream);
  } else {
    const bool exact = a.D == DP;
    if (chunked)
      return exact ? launch_one<DP, true, true>(kmap, vmap, a, B, smem, stream)
                   : launch_one<DP, false, true>(kmap, vmap, a, B, smem, stream);
    return exact ? launch_one<DP, true, false>(kmap, vmap, a, B, smem, stream)
                 : launch_one<DP, false, false>(kmap, vmap, a, B, smem, stream);
  }
}

}  // namespace

// fp32 q and out (the FMA kernel). k, v int8 [B, H, S, D]; scales fp32
// [B, H, S]; bias fp32 with strides (bias_bs, bias_hs, 1); pad bool [B, S];
// D = head_dim, a multiple of 16 (common.cuh::with_head_dim; past 256 the
// deep route).
// Returns a CUDA error code.
extern "C" int mk_decode_cross_attn_int8(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* bias, const void* pad, void* out, int B,
                                         int H, int Kb, int S, long long bias_bs,
                                         long long bias_hs, int head_dim, int chunk,
                                         void* stream) {
  namespace ca = mk::cross_attn;
  ca::Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.bias = static_cast<const float*>(bias);
  a.pad = static_cast<const uint8_t*>(pad);
  a.out = out;
  a.H = H;
  a.Kb = Kb;
  a.S = S;
  a.D = a.kv_rs = head_dim;
  a.chunk = chunk;
  a.q_bs = (long long)H * Kb * head_dim;  // q and out: [B, H, Kb, D]
  a.q_hs = (long long)Kb * head_dim;
  a.q_js = head_dim;
  a.bias_bs = bias_bs;
  a.bias_hs = bias_hs;
  if (head_dim % 16) return (int)cudaErrorInvalidValue;  // the int8 rows' 16-byte loads
  return mk::with_head_dim(head_dim, [&](auto d) {
    return ca::launch<decltype(d)::value, float, int8_t, true>(a, B,
                                                               static_cast<cudaStream_t>(stream));
  });
}

// bf16 q and out (the tensor cores), the other arguments as above; q, k and v
// on 16-byte boundaries. The K/V copies start before the kernel waits on the
// previous kernel of the stream (programmatic dependent launch): k and v must
// not be written by that kernel. Returns a CUDA error code.
extern "C" int mk_decode_cross_attn_int8_sm90(const void* q, const void* k, const void* v,
                                              const void* k_scale, const void* v_scale,
                                              const void* bias, const void* pad, void* out,
                                              int B, int H, int Kb, int S, long long bias_bs,
                                              long long bias_hs, int head_dim, int chunk,
                                              void* stream) {
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.bias = static_cast<const float*>(bias);
  a.pad = static_cast<const uint8_t*>(pad);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.Kb = Kb;
  a.S = S;
  a.D = head_dim;
  a.bias_bs = bias_bs;
  a.bias_hs = bias_hs;
  if (head_dim % 16) return (int)cudaErrorInvalidValue;  // the int8 rows' TMA strides
  return mk::with_head_dim(head_dim, [&](auto d) {
    constexpr int DP = decltype(d)::value;
    constexpr int W = Tiles<DP>::W;  // the boxes' columns (the deep route: a chunk's)
    CUtensorMap kmap, vmap;
    if (const int err = cache_map<W>(&kmap, k, (long long)B * H, S, head_dim)) return err;
    if (const int err = cache_map<W>(&vmap, v, (long long)B * H, S, head_dim)) return err;
    return launch_sm90<DP>(kmap, vmap, a, B, chunk < S, static_cast<cudaStream_t>(stream));
  });
}
