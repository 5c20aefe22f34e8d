// Hopper primitives shared by the port's tensor-core kernels: shared-memory
// addresses, mbarriers, TMA copies, wgmma (m64n64k16 for the attention
// cores, m64nNk16 at the N extents of the beam rows for the weight-streaming
// products and at N = 64 and 128 for K8, with A from shared memory or from
// registers; descriptors of 128-byte and 32-byte swizzled and of unswizzled
// tiles; HeadTile and head_maps, the layout and tensor maps of a bf16 head
// tile at the instance widths 32, 64, 80, 128, 192 and 256), the
// exact int8 -> bf16 widening, programmatic dependent launch, and the
// run-time lookup of cuTensorMapEncodeTiled. Used by flash_fwd_sm90.cuh and
// flash_bwd_sm90.cuh (K1, K3, K4, K5), skinny_gemm_sm90.cuh (K2, K2-q8, K7),
// decode_attn_sm90.cuh (K6, K7) and bottleneck_sm90.cuh (K8).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <stdint.h>

#include "common.cuh"

namespace mk {
namespace sm90 {

// ---- shared memory, mbarriers, TMA ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also announces `bytes` of TMA transfer
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of this parity has completed; a phase that
// never completes (a lost copy) traps after ~2^28 tries, an error and not a hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries == (1u << 28)) __trap();
  }
}

// a 64 x 64 bf16 box at (0, row, bh) of a [B*H, rows, 64] map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Descriptor of a 128-byte swizzled tile: rows of 128 bytes, 8-row groups
// 1024 bytes apart (SBO); LBO is not read at these widths. Serves the K-major
// q, pos_q, k, pos_k tiles and v read MN-major.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Descriptor of a 32-byte swizzled tile: rows of 32 bytes (16 bf16), 8-row
// groups 256 bytes apart (SBO); LBO is not read at this width. Serves the
// 16-column boxes of a head tile (HeadTile: columns 64..79 at DP 80, both
// halves at DP 32), K-major and read MN-major, as sw128_desc serves the
// 64-column ones.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (16ull << 32) |
         (3ull << 62);
}

// Descriptor of a K-major tile without swizzle ("interleave"): 8 x 16-byte
// core matrices, each 8 rows of 16 bytes stored contiguously; `lbo` bytes
// from one core matrix to the next along K, `sbo` bytes from one 8-row group
// to the next along M (or N). K8's h1 and h2 (bottleneck_sm90.cuh).
__device__ __forceinline__ uint64_t interleave_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFFu) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFFu) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // at most N committed groups still running
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait() { wgmma_wait_n<0>(); }  // every committed group done
// dst[i] = i < n ? src[i] : 0 for i < m, by the first `threads` threads of the
// block (tid below that), eight loads in flight a thread before their stores
__device__ __forceinline__ void copy_f32(float* dst, const float* __restrict__ src, int n, int m,
                                         int tid, int threads) {
  for (int i0 = tid; i0 < m; i0 += 8 * threads) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k * threads;
      v[k] = i < n ? src[i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (i0 + k * threads < m) dst[i0 + k * threads] = v[k];
  }
}

// keeps the compiler from moving accumulator reads or writes across a wait
__device__ __forceinline__ void fence_operand(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MK_WG_D                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MK_WG_ACC(d)                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A . B^T, A and B both K-major in shared memory; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MK_WG_D
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MK_WG_ACC(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B, A from registers (four bf16 pairs), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MK_WG_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MK_WG_ACC(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d += A . B, A K-major and B MN-major (the transpose bit) in shared memory:
// the deep route's P . v, with P written to shared memory by another warpgroup
__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MK_WG_D
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : MK_WG_ACC(d)
      : "l"(da), "l"(db), "r"(1));
}

// A warpgroup's per-thread register budget moved down to N (the producer) or
// up to N (a consumer), out of the CTA's pool fixed at launch; every warp of
// the warpgroup executes it.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// round to nearest even, lo in the low half (the smaller k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mma.sync m16n8k16 (the decode cross-attentions) ----------------------

// c += A . B, bf16 products, fp32 sums; a and b as mma.sync's fragments
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// byte offset of (row, 16-byte unit u) in a 128-byte swizzled tile
__device__ __forceinline__ uint32_t swz(int row, int u) {
  return row * 128 + ((u ^ (row & 7)) * 16);
}

// byte offset of (row, 16-byte unit u) in a 32-byte swizzled tile: bit 4 of
// the address flipped by bit 7 (row bit 2), as TMA's 32-byte swizzle writes it
__device__ __forceinline__ uint32_t swz32(int row, int u) {
  return row * 32 + ((u ^ ((row >> 2) & 1)) * 16);
}

// Four int8 (one 32-bit word, byte 0 the lowest) widened to two bf16 pairs,
// lo = {b0, b1} and hi = {b2, b3} (the smaller index in the low half), exactly:
// 2^23 + 128 + x is built as fp32 bits with the byte x ^ 0x80 as its low
// mantissa bits, 2^23 + 128 subtracted gives x, and an integer of |x| <= 128
// leaves the fp32 value's low 16 bits zero, so its high half is x in bf16.
// Bit moves and fp32 adds only: no conversion instructions.
__device__ __forceinline__ void widen_i8x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t magic = 0x4B000000u;
  const float f0 = __uint_as_float(__byte_perm(u, magic, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, magic, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, magic, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, magic, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// a box at (c0, c1, c2) of a 3-D map into shared memory
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a box at (c0, c1, c2, c3) of a 4-D map into shared memory; coordinates
// off the tensor (negative too) read as zeros
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a box of a 4-D map from shared memory to device memory, in this thread's
// bulk group; coordinates off the tensor are not written
__device__ __forceinline__ void tma_store4(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores: all but N have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// this thread's bulk stores: all complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory made visible to wgmma and TMA (the
// async proxy); each writing thread fences, then the readers synchronise
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of the first `count` threads of the block (count a multiple of 32)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// previous kernel on the stream still runs; grid_wait() returns once that
// kernel has completed and its writes are visible. launch_dependents() lets
// the next such kernel start early.
__device__ __forceinline__ void grid_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B^T, m64nNk16: A (64 rows) and B (N rows) both K-major in shared
// memory, 128-byte swizzled; accumulate = 0 overwrites d. The accumulator
// holds N / 2 fp32 a thread: position i = 4 j + 2 hh + e is row
// 16 warp + lane / 4 + 8 hh, column 8 j + 2 (lane % 4) + e.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void ss(float (&d)[4], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}"
        ", %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<24> {
  static __device__ __forceinline__ void ss(float (&d)[12], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}"
        ", %12, %13, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<40> {
  static __device__ __forceinline__ void ss(float (&d)[20], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19}"
        ", %20, %21, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
  }
  // d += A . B^T, A (64 x 16) from registers (four bf16 pairs a thread, as
  // mma.sync's m16n8k16 A fragment per warp), B K-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[8], uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
  // the same with B MN-major in shared memory (the transpose bit), as
  // wgmma_rs reads v: the 16 columns past 64 of an 80-wide head
  static __device__ __forceinline__ void rs_t(float (&d)[8], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
  }
  // d += A . B^T, A (64 x 16) from registers (four bf16 pairs a thread, as
  // mma.sync's m16n8k16 A fragment per warp), B K-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void ss(float (&d)[24], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}"
      ", %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc));
  }
  // d += A . B^T, A (64 x 16) from registers (four bf16 pairs a thread, as
  // mma.sync's m16n8k16 A fragment per warp), B K-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[24], uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23}"
      ", {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void ss(float (&d)[40], uint64_t da, uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}"
      ", %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(acc));
  }
  // d += A . B^T, A (64 x 16) from registers (four bf16 pairs a thread, as
  // mma.sync's m16n8k16 A fragment per warp), B K-major in shared memory
  static __device__ __forceinline__ void rs(float (&d)[40], uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39}"
      ", {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    wgmma_ss(d, da, db, acc);
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}"
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
};

// ---- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map of rank 2 to 5 (dims and box innermost first, strides in
// bytes of dims 1..), zeros past the end. 0 or a cudaError_t code.
inline int tiled_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorInvalidDeviceFunction;
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A bf16 tensor map, 128-byte swizzled.
inline int bf16_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box) {
  return tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, rank, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// The shared-memory layout of a 64-row bf16 head tile at instance width DP
// (32, 64, 80, 128, 192, 256; common.cuh::with_head_dim): NLO boxes of 64 columns under
// the 128-byte swizzle (64 rows of 128 bytes, 8 KB each), then NHI boxes of
// 16 columns under the 32-byte swizzle (64 rows of 32 bytes, 2 KB each),
// since a row wider than 128 bytes, or of 64 bytes, is not one 128-byte
// swizzle row: 32 = 2 x 16, 64 = 64, 80 = 64 + 16, 128 = 2 x 64, 192 = 3 x 64,
// 256 = 4 x 64. Each box
// has its own wgmma descriptors; a 16-column k-step lies in one box.
template <int DP>
struct HeadTile {
  static_assert(DP == 32 || DP == 64 || DP == 80 || DP == 128 || DP == 192 || DP == 256,
                "instances: 32, 64, 80, 128, 192, 256");
  static constexpr int NLO = DP / 64, NHI = (DP % 64) / 16;
  static constexpr uint32_t LO_BOX = 64 * 128, HI_BOX = 64 * 32;
  static constexpr uint32_t BYTES = 64 * DP * 2;
  // offset of the box that holds 16-column k-step kk, and of the k-step in it
  static __host__ __device__ constexpr uint32_t kstep(int kk) {
    return kk < 4 * NLO ? (kk / 4) * LO_BOX + 32 * (kk % 4)
                        : NLO * LO_BOX + (kk - 4 * NLO) * HI_BOX;
  }
  // descriptor of k-step kk of a K-major tile at t (q, k, pos_q, pos_k, dO, v in dP)
  static __device__ __forceinline__ uint64_t kdesc(uint32_t t, int kk) {
    return kk < 4 * NLO ? sw128_desc(t + kstep(kk)) : sw32_desc(t + kstep(kk));
  }
  // address of 16-byte unit u (columns 8 u .. 8 u + 7, u < DP / 8) of row
  // `row`, in as few operations as each instance allows (one generic
  // shift-and-mask form for all made K7's cross-attention 1.2x slower at 80)
  static __device__ __forceinline__ uint32_t unit(uint32_t t, int row, int u) {
    if constexpr (NHI == 0) {  // 64-column boxes only
      return NLO == 1 ? t + swz(row, u) : t + (u >> 3) * LO_BOX + swz(row, u & 7);
    } else if constexpr (NLO == 0) {  // 16-column boxes only
      return t + (u >> 1) * HI_BOX + swz32(row, u & 1);
    } else {  // one of each (DP 80)
      static_assert(NLO == 1 && NHI == 1, "DP 80: a 64-column box, then a 16-column one");
      return u < 8 ? t + swz(row, u) : t + LO_BOX + swz32(row, u - 8);
    }
  }
};

// A bf16 stream [n, rows, D] (D a multiple of 8, 16-byte aligned) as the
// boxes of HeadTile<DP> (DP >= D), each of box_rows rows: lo the 64-column
// boxes (128-byte swizzle), hi the 16-column ones (32-byte swizzle); a map
// not needed at DP is left unset. The maps span the true D, so the columns
// of a box past D, and the rows past the end, are zeros. 0 or a cudaError_t
// code.
inline int head_maps(CUtensorMap* lo, CUtensorMap* hi, const void* ptr, int D, int DP, int rows,
                     long long n, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};  // bytes
  if (DP >= 64) {
    const cuuint32_t box_lo[3] = {64, (cuuint32_t)box_rows, 1};
    if (const int err = tiled_map(lo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 3, dims, strides,
                                  box_lo, CU_TENSOR_MAP_SWIZZLE_128B))
      return err;
  }
  if (DP % 64 == 0) return 0;
  const cuuint32_t box_hi[3] = {16, (cuuint32_t)box_rows, 1};
  return tiled_map(hi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 3, dims, strides, box_hi,
                   CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace sm90
}  // namespace mk
