// Multi-head attention forward for Hopper (sm_90a), f32 in and out, on the
// FP32 pipes (FFMA), instantiated at head dim 64 (the EVA02 tagger) and 32 (the
// CAFormer of CCIP). The bf16 form is flash_attention.cu (wgmma); this is the
// form a model whose compute dtype is float32 hands the kernel.
//
// Replaces the TPU kernel anime_illust_image_searcher_tpu/ops/flash_attention.py
// (`mha_attention` at :62, `pl.pallas_call` at :109, body `_attn_kernel` at :39)
// run on f32 q, k and v:
//     o = softmax(q k^T * Dh^-1/2 + bias) v
// with f32 scores, an f32 softmax, p kept in f32 (no rounding) for p.v, f32
// accumulation, keys >= S masked to -inf and query rows >= S not written.
//
// No TF32: the port turns TF32 off because its f32 paths must keep all 24
// mantissa bits, so both products are FFMA from shared memory.
//
// Bound, per layer, against 67 TFLOP/s f32 (FFMA), 3.35 TB/s and the MUFU's 16
// exp2 a clock on each of 132 SMs:
//   EVA02-L, B=32, H=16, S=1025, Dh=64: 137.7 GFLOP -> 2.055 ms, 537 MB ->
//     0.160 ms, 538 M exp2 -> 0.13 ms: the FMA pipes bound it.
//   CAFormer-24 stage 3, B=64, H=10, S=576, Dh=32: 27.2 GFLOP -> 0.406 ms,
//     189 MB -> 0.056 ms: the FMA pipes.
//   CAFormer-24 stage 4, B=64, H=16, S=144, Dh=32: 2.72 GFLOP -> 0.041 ms,
//     75.5 MB -> 0.023 ms: the FMA pipes.
// Split-precision products on the tensor cores (3 TF32 passes, 495 TFLOP/s)
// would lower the operations' bound about 2.5x; that is a redesign, not this
// kernel.
//
// Why it streams K and V: the TPU kernel keeps all of K and V for a group of
// heads resident in VMEM and does a single-pass softmax. In f32 one head's K
// plus V at S=1025, Dh=64 is 525 KB, more than twice the 227 KB of shared
// memory a Hopper block may use. So 64-key K/V tiles stream through shared
// memory under an online softmax.
//
// This design (one template on the head dim Dh), simple first:
//   grid   = (ceil(S/64), H, B), the query tile fastest, so the blocks of one
//            head share its K/V in L2. block = 256 threads as a 16 x 16 grid
//            (ty = tid / 16, tx = tid % 16): a thread owns query rows 4ty..4ty+3
//            of the block's 64, keys tx + 16j (j < 4) of each 64-key tile, and
//            head-dim columns (Dh/16) tx .. of O. A warp holds two ty, so a
//            row's 16 threads are one half-warp (shuffles xor 1, 2, 4, 8).
//   smem   : Q (64 x Dh), two stages of K and of V (64 x Dh each) and P
//            (64 x 64), all f32, every row padded by 4 floats: the K reads of
//            Q.K^T (8 threads of a quarter-warp on 8 consecutive keys, 16 bytes
//            each) then land on distinct banks (a row is Dh/4 + 1 16-byte
//            units long, odd), and the P stores of two ty rows 4 apart fall on
//            the two halves of the banks. Q and P reads are broadcasts (one
//            row per half-warp); V reads are a row's consecutive columns.
//            About 102 KB at Dh=64 (two blocks an SM) and 62 KB at Dh=32.
//   loads  : cp.async 16-byte chunks into the padded rows, K/V of tile j+1 in
//            flight while tile j is computed; rows past S are zero-filled by
//            the source size (their addresses kept in bounds), so nothing past
//            S is read and a zero V row never meets p = 0 as NaN.
//   S=QK^T : a 4 x 4 register micro-tile, float4 reads of Q rows and K rows
//            along Dh, 64 FFMA per 8 shared loads.
//   softmax: max on raw scores (the 16 threads of a row reduce by shuffles);
//            p = exp2(s*c - m*c), c = Dh^-1/2 * log2(e): one FFMA and one ex2
//            per score. The running max starts at -inf; tile 0 always holds key
//            0, so after it the max is finite and the rescale factor
//            exp2((m_old - m_new) c) is exp2(-inf) = 0 on the first tile, never
//            exp2(-inf - -inf). The key < S mask only on a ragged last tile.
//   O+=PV  : P (f32) through shared memory, a 4 x Dh/16 register micro-tile,
//            float4 reads of P rows and Dh/16-wide reads of V rows.
//   end    : O / rowsum (an IEEE divide), rows < S stored through the output
//            strides (a (B, S, H, Dh) buffer, so merging heads is a view).
// Inputs are taken with their (B, H, S) strides and a unit Dh stride, so the
// head-split views of a (B, S, H*Dh) or (B, S, 3*H*Dh) projection need no copy;
// the (B, H, S) strides must be multiples of 4 and the bases 16-byte aligned
// (the wrapper checks).
//
// Known costs of the simple design: three __syncthreads a tile; shared-memory
// reads (8 loads per 64 FFMA, half of them broadcasts) compete with the FMA
// pipes; a ragged last query tile (S=1025: one row of 64) costs a whole block.
// Left for later: split-precision tensor-core products, larger micro-tiles,
// a producer warp with TMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;     // query rows a block
constexpr int kBlockK = 64;     // keys a K/V tile
constexpr int kRowsPerThread = 4;
constexpr int kKeysPerThread = 4;
constexpr int kPad = 4;         // floats of padding a shared-memory row
constexpr int kLdP = kBlockK + kPad;
constexpr float kLog2e = 1.4426950408889634f;

template <int Dh>
struct Geometry {
  static_assert(Dh == 64 || Dh == 32, "head dim 64 or 32");
  static constexpr int kLd = Dh + kPad;                     // floats a Q/K/V row
  static constexpr int kChunks = Dh / 4;                    // 16-byte chunks a row
  static constexpr int kTile = kBlockK * kLd;               // floats a K or V tile
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + kBlockQ * kLd;       // 2 stages of K
  static constexpr int kVOff = kKOff + 2 * kTile;           // 2 stages of V
  static constexpr int kPOff = kVOff + 2 * kTile;
  static constexpr int kSmemBytes = (kPOff + kBlockQ * kLdP) * 4;
  static constexpr int kCols = Dh / 16;                     // O columns a thread
};

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + 64) of a (S, Dh) f32 head into a padded shared tile;
// rows >= S are zero-filled from the head's row 0
template <int Dh>
__device__ __forceinline__ void load_tile(float* dst, const float* head, long long stride_s,
                                          int row0, int S, int tid) {
  using G = Geometry<Dh>;
  static_assert(kBlockK * G::kChunks % kThreads == 0, "whole passes");
#pragma unroll
  for (int p = 0; p < kBlockK * G::kChunks / kThreads; ++p) {
    const int i = tid + p * kThreads;
    const int row = i / G::kChunks, ch = i % G::kChunks;
    const bool ok = row0 + row < S;
    const float* src = ok ? head + (row0 + row) * stride_s + ch * 4 : head;
    cp_async_16(smem_u32(dst + row * G::kLd + ch * 4), src, ok ? 16 : 0);
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             Strides qs, Strides ks, Strides vs, Strides os, int S, float c) {
  using G = Geometry<Dh>;
  constexpr int kCols = G::kCols;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sq = smem + G::kQOff;
  float* sp = smem + G::kPOff;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;

  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  const int last_keys = S % kBlockK;   // valid keys of a ragged last tile, else 0

  load_tile<Dh>(sq, qb, qs.s, q0, S, tid);
  load_tile<Dh>(smem + G::kKOff, kb, ks.s, 0, S, tid);
  load_tile<Dh>(smem + G::kVOff, vb, vs.s, 0, S, tid);
  cp_async_commit();   // one group: Q and tile 0

  float acc[kRowsPerThread][kCols];
  float m[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) acc[i][cc] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {   // tile j+1 into the other stage, freed at the end of j-1
      load_tile<Dh>(smem + G::kKOff + (stage ^ 1) * G::kTile, kb, ks.s, (j + 1) * kBlockK,
                    S, tid);
      load_tile<Dh>(smem + G::kVOff + (stage ^ 1) * G::kTile, vb, vs.s, (j + 1) * kBlockK,
                    S, tid);
      cp_async_commit();
      cp_async_wait<1>();    // everything but tile j+1 has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();         // every thread's copies of tile j (and Q)

    const float* kt = smem + G::kKOff + stage * G::kTile;
    const float* vt = smem + G::kVOff + stage * G::kTile;

    // S = Q K^T: rows 4ty + i, keys tx + 16 jj
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) s[i][jj] = 0.f;
    }
    const float* qr = sq + (kRowsPerThread * ty) * G::kLd;
    const float* kr = kt + tx * G::kLd;
#pragma unroll
    for (int d = 0; d < Dh; d += 4) {
      float4 qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qr + i * G::kLd + d);
      }
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        kv[jj] = *reinterpret_cast<const float4*>(kr + 16 * jj * G::kLd + d);
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int jj = 0; jj < kKeysPerThread; ++jj) {
          float acc_s = s[i][jj];
          acc_s = fmaf(qv[i].x, kv[jj].x, acc_s);
          acc_s = fmaf(qv[i].y, kv[jj].y, acc_s);
          acc_s = fmaf(qv[i].z, kv[jj].z, acc_s);
          acc_s = fmaf(qv[i].w, kv[jj].w, acc_s);
          s[i][jj] = acc_s;
        }
      }
    }

    if (last_keys != 0 && j == n_tiles - 1) {
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        if (tx + 16 * jj >= last_keys) {
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) s[i][jj] = -INFINITY;
        }
      }
    }

    // online softmax; a row's 64 scores are spread over the 16 threads of a
    // half-warp
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) mx = fmaxf(mx, s[i][jj]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float alpha = ex2((m[i] - mx) * c);   // 0 on the first tile
      m[i] = mx;
      const float mc = mx * c;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kKeysPerThread; ++jj) {
        const float p = ex2(fmaf(s[i][jj], c, -mc));
        sum += p;
        sp[(kRowsPerThread * ty + i) * kLdP + tx + 16 * jj] = p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();         // P complete

    // O += P V: rows 4ty + i, columns kCols * tx + cc
    const float* pr = sp + (kRowsPerThread * ty) * kLdP;
    const float* vc = vt + kCols * tx;
#pragma unroll
    for (int key = 0; key < kBlockK; key += 4) {
      float4 pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(pr + i * kLdP + key);
      }
      float vv[4][kCols];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (kCols == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vc + (key + kk) * G::kLd);
          vv[kk][0] = t.x; vv[kk][1] = t.y; vv[kk][2] = t.z; vv[kk][3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vc + (key + kk) * G::kLd);
          vv[kk][0] = t.x; vv[kk][1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          float a = acc[i][cc];
          a = fmaf(pv[i].x, vv[0][cc], a);
          a = fmaf(pv[i].y, vv[1][cc], a);
          a = fmaf(pv[i].z, vv[2][cc], a);
          a = fmaf(pv[i].w, vv[3][cc], a);
          acc[i][cc] = a;
        }
      }
    }
    __syncthreads();         // P and this stage no longer read
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = q0 + kRowsPerThread * ty + i;
    if (row < S) {
      float* dst = ob + row * os.s + kCols * tx;
      if constexpr (kCols == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0] / sum, acc[i][1] / sum,
                                                      acc[i][2] / sum, acc[i][3] / sum);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[i][0] / sum, acc[i][1] / sum);
      }
    }
  }
}

template <int Dh>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
           const Strides& qs, const Strides& ks, const Strides& vs, const Strides& os,
           float scale, cudaStream_t stream) {
  constexpr int kSmem = Geometry<Dh>::kSmemBytes;
  // over 48 KB of dynamic shared memory needs the opt-in (per device; cheap)
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_f32<Dh>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  attn_fwd_f32<Dh><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      qs, ks, vs, os, S, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes, the argument list of aiis_flash_attention_bf16.
// Pointers are device addresses of f32 tensors, 16-byte aligned; the strides
// are in elements, for the (B, H, S) axes, multiples of 4, with a unit Dh
// stride. The wrapper (ops/flash_attention.py) checks shapes, dtype, device
// and alignment. Dh must be 64 or 32. Returns the CUDA error of the set-up or
// the launch (0 on success).
extern "C" int aiis_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int S, int Dh,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss};
  const Strides vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64) return launch<64>(q, k, v, o, B, H, S, qs, ks, vs, os, scale, st);
  if (Dh == 32) return launch<32>(q, k, v, o, B, H, S, qs, ks, vs, os, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
