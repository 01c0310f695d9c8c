// Multi-head attention forward for Hopper (sm_90a), bf16 in and out, on wgmma.
//
// Replaces the TPU kernel anime_illust_image_searcher_tpu/ops/flash_attention.py
// (`mha_attention` at :62, `pl.pallas_call` at :109, body `_attn_kernel` at :39):
//     o = softmax(q k^T * Dh^-1/2 + bias) v
// with f32 scores and softmax, p rounded to bf16 before p.v, f32 accumulation,
// keys >= S masked to -inf and query rows >= S not written.
//
// Why it streams K and V: the TPU kernel keeps all of K and V for a group of
// heads resident in VMEM and does a single-pass softmax. At EVA02-Large's
// S=1025, Dh=64, K plus V of ONE head is 262 KB in bf16, more than the 227 KB of
// shared memory a Hopper block may use. So this kernel streams 64-key K/V tiles
// through shared memory with an online softmax (running row max and row sum in
// f32 registers).
//
// Bound at the EVA02-Large shape (B=32, H=16, S=1025, Dh=64), per layer:
//   4*B*H*S^2*Dh = 137.7 GFLOP  -> 0.139 ms at 989 TFLOP/s (bf16 dense)
//   q, k, v, o   = 269 MB       -> 0.080 ms at 3.35 TB/s
// so it is compute-bound. At Dh=64 the softmax's one exp2 per score costs the
// MUFU unit (16/clk/SM) as long as the 256 tensor-core FLOPs of that score, so
// the exps and the products have to overlap to get near the bound.
//
// The earlier design (mma.sync m16n8k16, 64-row blocks) ran at 15% of the bound
// and 2.1x SDPA's time: mma.sync is Ampere's warp-level instruction and does
// not reach Hopper's tensor-core rate; every operand fragment was loaded from
// shared memory by hand (V as four 16-bit scalar loads per mma, so P.V was
// bound by load instructions); a K/V tile served only 64 query rows; and each
// score paid a separate scale multiply, __expf and key < S test.
//
// This design:
//   grid   = (ceil(S/128), H, B), the query tile fastest, so the blocks of one
//            head share its K/V in L2. block = 2 warpgroups (256 threads), each
//            owning 64 query rows: one K/V tile serves 128 rows. A warpgroup
//            whose rows are all >= S skips its products but keeps to the loads
//            and barriers.
//   smem   : Q (128 x 64) and double-buffered 64-key K and V tiles, every row
//            of Dh=64 bf16 exactly one 128-byte swizzle atom wide. cp.async
//            16-byte chunks land at chunk ^ (row % 8) (the 128B swizzle wgmma
//            reads), keys and queries past S zero-filled by the source size.
//            Each tile base is 1024-byte aligned (dynamic smem, aligned here).
//            The tile loop is unrolled over the two stages and the K/V source
//            pointers step a tile at a time, so a tile costs no address math
//            beyond two compares.
//   S=QK^T : wgmma m64n64k16, A = Q and B = K from shared memory, both K-major
//            (Dh contiguous); 4 k-steps, each moving the descriptors' start
//            32 bytes along the swizzled row.
//   softmax: in registers, on the accumulator layout (rows 16w+g and 16w+g+8,
//            column pairs 8i+2t; quad shuffles for the row max and sum). Max on
//            raw scores; p = exp2(s*c - m*c), c = Dh^-1/2 * log2(e), one FFMA
//            and one ex2 per score. The key < S mask only on the last tile, and
//            only when S % 64 != 0.
//   O+=PV  : wgmma m64n64k16 with A = P from registers (the accumulator layout
//            of S packed to bf16 is the register-A fragment layout) and B = V
//            from shared memory, MN-major (V stored keys x Dh) with the
//            transpose-B immediate; 4 k-steps of 16 keys, 2048 bytes apart.
//   end    : O / rowsum, rounded to bf16, rows < S stored through the output
//            strides (a (B, S, H, Dh) buffer, so merging heads is a view).
// Inputs are taken with their (B, H, S) strides and a unit Dh stride, so the
// head-split views of a (B, S, H*Dh) projection need no copy.
//
// Ordering (where a first wgmma kernel goes wrong):
//   - wgmma reads shared memory through the async proxy. cp.async writes it
//     through the generic one, so after cp.async.wait_group each thread issues
//     fence.proxy.async.shared::cta, then __syncthreads(), before any wgmma
//     reads the tile. wgmma.fence alone orders only register accesses.
//   - wgmma.fence before the first wgmma of each product whose accumulator or
//     A registers were written by ordinary instructions (after the softmax read
//     S, after O was rescaled and P packed).
//   - commit_group and wait_group 0 before the softmax reads S and before the
//     stage is overwritten; empty asm statements tie the accumulator registers
//     to either side, so the compiler moves no access across the async region.
//   - accumulator arrays are indexed only with compile-time indices.
//
// Left for later: TMA loads with mbarriers in place of cp.async and
// __syncthreads, a producer warp with setmaxnreg, pingpong scheduling between
// the two warpgroups, overlapping one tile's softmax with the next Q.K^T, and
// persistent blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kDh = 64;                     // head dim: one 128-byte swizzle row
constexpr int kRowBytes = kDh * 2;
constexpr int kWarpGroups = 2;
constexpr int kThreads = kWarpGroups * 128;
constexpr int kRowsPerWG = 64;              // wgmma M
constexpr int kBlockQ = kWarpGroups * kRowsPerWG;
constexpr int kBlockK = 64;                 // keys per K/V tile
constexpr int kChunks = kRowBytes / 16;     // 16-byte chunks per row
constexpr int kTileBytes = kBlockK * kRowBytes;              // 8 KB
constexpr int kQBytes = kBlockQ * kRowBytes;                 // 16 KB
constexpr int kKOff = kQBytes;                               // 2 stages of K
constexpr int kVOff = kKOff + 2 * kTileBytes;                // 2 stages of V
constexpr int kSmemBytes = kVOff + 2 * kTileBytes + 1024;    // + alignment slack
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `ch` of row `row` in a 128B-swizzled tile
__device__ __forceinline__ uint32_t swizzle(int row, int ch) {
  return row * kRowBytes + ((ch ^ (row & 7)) << 4);
}

// 16-byte async copy global -> shared; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled tile whose 8-row groups
// are 1024 bytes apart (SBO). LBO is unused: K-major rows and MN-major rows of
// this tile are both exactly one 64-element swizzle atom wide.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;                 // LBO = 16 bytes
  d |= static_cast<uint64_t>(1024 >> 4) << 32;         // SBO = 1024 bytes
  d |= static_cast<uint64_t>(1) << 62;                 // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of r across the async wgmma region
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

#define AIIS_ACC32(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),     \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
  "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),  \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define AIIS_ACC32_REGS                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "        \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A.B^T, m64n64k16, A and B K-major in shared memory.
// ScaleD = 0 overwrites d, 1 accumulates (an immediate: no predicate set-up
// between the wgmmas of a group).
template <int ScaleD>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AIIS_ACC32_REGS
      ", %32, %33, %34, 1, 1, 0, 0;\n"
      : AIIS_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "n"(ScaleD));
}

// d += A.B, m64n64k16, A from registers, B MN-major in shared memory (trans-b).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " AIIS_ACC32_REGS
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : AIIS_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_wgmma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
               Strides qs, Strides ks, Strides vs, Strides os, int S, float c) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;   // warp in the warpgroup: rows 16*warp..
  const int lane = tid & 31;
  const int g = lane >> 2;           // accumulator row in the warp's 8-row half
  const int t = lane & 3;            // accumulator column pair
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;

  const uint16_t* qb = q + b * qs.b + h * qs.h;
  const uint16_t* kb = k + b * ks.b + h * ks.h;
  const uint16_t* vb = v + b * vs.b + h * vs.h;
  uint16_t* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBlockQ * kChunks; i += kThreads) {
    const int row = i / kChunks, ch = i % kChunks;
    const bool valid = q0 + row < S;
    const long long src_row = valid ? q0 + row : 0;   // keep the address in bounds
    cp_async_16(smem + swizzle(row, ch), qb + src_row * qs.s + ch * 8, valid ? 16 : 0);
  }
  // K/V: each thread copies chunk lch of rows lrow and lrow + 32 of a tile (the
  // same swizzle phase), from pointers that step one tile per load: indexing
  // each tile's rows afresh in 64-bit arithmetic measurably slowed the kernel.
  const int lrow = tid / kChunks, lch = tid % kChunks;
  const uint32_t lsw = swizzle(lrow, lch);
  const long long k32 = 32 * ks.s, v32 = 32 * vs.s;
  const int key_lim = S - lrow;   // rows lrow (+32) of the tile at key0 exist while key0 (+32) < key_lim
  const uint16_t* kp = kb + lrow * ks.s + lch * 8;
  const uint16_t* vp = vb + lrow * vs.s + lch * 8;
  auto load_kv = [&](int stage, int key0) {
    const uint32_t dst = smem + stage * kTileBytes + lsw;
    const bool v0 = key0 < key_lim, v1 = key0 + 32 < key_lim;
    cp_async_16(dst + kKOff, v0 ? kp : kb, v0 ? 16 : 0);   // past S: zero-fill from row 0
    cp_async_16(dst + kVOff, v0 ? vp : vb, v0 ? 16 : 0);
    cp_async_16(dst + kKOff + 32 * kRowBytes, v1 ? kp + k32 : kb, v1 ? 16 : 0);
    cp_async_16(dst + kVOff + 32 * kRowBytes, v1 ? vp + v32 : vb, v1 ? 16 : 0);
    cp_async_commit();
    kp += 2 * k32;
    vp += 2 * v32;
  };
  load_kv(0, 0);   // one group with Q

  const bool active = q0 + wg * kRowsPerWG < S;   // uniform over the warpgroup
  const uint64_t q_desc = desc_sw128(smem + wg * kRowsPerWG * kRowBytes);
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  const int last_keys = S % kBlockK;   // valid keys of a ragged last tile, else 0

  float acc[32];   // O: rows 16*warp+g (+8), columns 8i+2t(+1)
  float s[32];     // scores, same layout over 64 keys
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of raw scores, rows g, g+8
  float l0 = 0.f, l1 = 0.f;               // this thread's part of the row sums

  // One K/V tile. kStage is a compile-time constant (the loop below is unrolled
  // over the two stages), so tile addresses and descriptors cost nothing per
  // tile.
  auto tile = [&](int j, auto stage_c) {
    constexpr int kStage = decltype(stage_c)::value;
    cp_async_wait_all();   // tile j (and Q) landed for this thread's copies
    fence_proxy_async();   // ... and is visible to wgmma's async proxy
    __syncthreads();       // every thread's copies; the other stage no longer read
    if (j + 1 < n_tiles) load_kv(kStage ^ 1, (j + 1) * kBlockK);
    if (!active) return;
    const uint32_t k_tile = smem + kKOff + kStage * kTileBytes;
    const uint32_t v_tile = smem + kVOff + kStage * kTileBytes;

    reg_fence(s);
    wgmma_fence();
    const uint64_t k_desc = desc_sw128(k_tile);
    wgmma_ss<0>(s, q_desc, k_desc);
    wgmma_ss<1>(s, q_desc + 2, k_desc + 2);   // +32 bytes: the next 16 of Dh
    wgmma_ss<1>(s, q_desc + 4, k_desc + 4);
    wgmma_ss<1>(s, q_desc + 6, k_desc + 6);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    if (last_keys != 0 && j == n_tiles - 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * i + 2 * t + e >= last_keys) {
            s[4 * i + e] = -INFINITY;
            s[4 * i + 2 + e] = -INFINITY;
          }
        }
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    // a row's 64 scores are spread over the 4 threads of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // tile 0 always holds key 0, so the max is finite from the first tile on;
    // on the first tile m = -inf and the factor is exp2(-inf) = 0
    const float alpha0 = ex2((m0 - mx0) * c);
    const float alpha1 = ex2((m1 - mx1) * c);
    m0 = mx0;
    m1 = mx1;
    const float mc0 = mx0 * c, mc1 = mx1 * c;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[4 * i] *= alpha0;
      acc[4 * i + 1] *= alpha0;
      acc[4 * i + 2] *= alpha1;
      acc[4 * i + 3] *= alpha1;
    }

    // P for keys 16kk..16kk+15 = score columns 2kk and 2kk+1: the register-A
    // fragment of k-step kk (rows g, g+8; keys 2t, 2t+1 and 2t+8, 2t+9)
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 2 * kk + half;
        const float p0 = ex2(fmaf(s[4 * i], c, -mc0));
        const float p1 = ex2(fmaf(s[4 * i + 1], c, -mc0));
        const float p2 = ex2(fmaf(s[4 * i + 2], c, -mc1));
        const float p3 = ex2(fmaf(s[4 * i + 3], c, -mc1));
        l0 += p0 + p1;
        l1 += p2 + p3;
        p[kk][2 * half] = pack_bf16x2(p0, p1);
        p[kk][2 * half + 1] = pack_bf16x2(p2, p3);
      }
    }

    reg_fence(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(p[kk][e]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tb(acc, p[kk], desc_sw128(v_tile + kk * 16 * kRowBytes));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
  };
  for (int j = 0; j < n_tiles; j += 2) {
    tile(j, std::integral_constant<int, 0>{});
    if (j + 1 < n_tiles) tile(j + 1, std::integral_constant<int, 1>{});
  }
  if (!active) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  const int r0 = q0 + wg * kRowsPerWG + warp * 16 + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(ob + r0 * os.s + col) =
          pack_bf16x2(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(ob + r1 * os.s + col) =
          pack_bf16x2(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    }
  }
}

}  // namespace

// C interface for ctypes. Pointers are device addresses of bf16 tensors; the
// strides are in elements, for the (B, H, S) axes, with a unit Dh stride. The
// wrapper (ops/flash_attention.py) checks shapes, dtype, device and alignment.
// Returns the CUDA error of the set-up or the launch (0 on success).
extern "C" int aiis_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int S, int Dh,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, void* stream) {
  if (Dh != kDh) return static_cast<int>(cudaErrorInvalidValue);
  // over 48 KB of dynamic shared memory needs the opt-in (per device; cheap)
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  attn_fwd_wgmma<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o),
      qs, ks, vs, os, S, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
