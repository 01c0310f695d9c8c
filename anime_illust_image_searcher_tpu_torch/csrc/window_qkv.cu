// The inputs of SwinV2's scaled cosine window attention, in one pass over the
// qkv projection, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no SwinV2. The port adds it
// because the plain route (a norm reduction over each head's rows of Dh=32 on
// strided views, a multiply into contiguous buffers, a copy of v) took 90-100
// device-ms of a 314 ms B=256 forward of SwinV2-B at 448 on an H100, where one
// pass over qkv needs about 13 (ops/window_attention.py).
//
//   in:  qkv (B, nW, S, 3, H, Dh) contiguous: the qkv Linear over the windows'
//        tokens (B, nW, S, 3C), head-major inside q, k and v.
//   out: q, k, v each (B, S, nW, H, Dh) contiguous, i.e. token-major
//        (B, nW*H, S, Dh) views for SDPA, so that its output comes back
//        token-major and the proj reads it without a copy:
//          q = q_row * scale[h] / max(|q_row|, eps)   (the logit scale folded in)
//          k = k_row / max(|k_row|, eps)
//          v = v_row (the same bits)
//        with the norm and the product in f32, rounded once.
//
// Bound: bytes. qkv read once and written once: 6 B N C elements a block, 38 GB
// a B=256 forward in bf16, 11.5 ms at 3.35 TB/s. Design: one thread a 16-byte
// vector of a head's row (8 bf16 or 4 f32), threads in input order, so the
// reads are coalesced and each token's q, k and v rows are written as runs of
// C elements; the Dh*elt/16 threads of one row (a power of two that divides
// 32, aligned in the warp) sum their squares with xor shuffles. Every lane
// takes part in the shuffles; lanes past the end load zeros and store
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void window_qkv_unit_kernel(const uint4* __restrict__ qkv, uint4* __restrict__ q,
                                       uint4* __restrict__ k, uint4* __restrict__ v,
                                       const float* __restrict__ scale, long long n_vec,
                                       int row_vec, int heads, int n_win, int seq, float eps) {
  constexpr int PER = 16 / sizeof(T);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n_vec; base += step) {
    const long long g = base + threadIdx.x;
    const bool live = g < n_vec;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (live) raw = qkv[g];
    const T* x = reinterpret_cast<const T*>(&raw);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float f = to_f32(x[i]);
      ss += f * f;
    }
    for (int o = row_vec / 2; o > 0; o /= 2) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (!live) continue;
    // g = (((token * 3 + which) * H + h) * row_vec + c), token = (b * nW + w) * S + s
    const int c = (int)(g % row_vec);
    long long row = g / row_vec;
    const int h = (int)(row % heads);
    row /= heads;
    const int which = (int)(row % 3);
    const long long token = row / 3;
    const int s = (int)(token % seq);
    const long long bw = token / seq;
    const int w = (int)(bw % n_win);
    const long long b = bw / n_win;
    const long long dst = (((b * seq + s) * n_win + w) * heads + h) * row_vec + c;
    if (which == 2) {
      v[dst] = raw;
      continue;
    }
    const float factor = (which == 0 ? scale[h] : 1.f) / fmaxf(sqrtf(ss), eps);
    uint4 out;
    T* y = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int i = 0; i < PER; ++i) from_f32(to_f32(x[i]) * factor, &y[i]);
    (which == 0 ? q : k)[dst] = out;
  }
}

template <typename T>
int launch(const void* qkv, void* q, void* k, void* v, const float* scale, long long batch,
           int n_win, int seq, int heads, int head_dim, float eps, cudaStream_t stream) {
  const int row_vec = head_dim * (int)sizeof(T) / 16;
  const long long n_vec = batch * n_win * seq * 3LL * heads * row_vec;
  const long long threads = 256, most = 132LL * 16;
  long long blocks = (n_vec + threads - 1) / threads;
  blocks = blocks < most ? blocks : most;
  window_qkv_unit_kernel<T><<<(int)blocks, (int)threads, 0, stream>>>(
      static_cast<const uint4*>(qkv), static_cast<uint4*>(q), static_cast<uint4*>(k),
      static_cast<uint4*>(v), scale, n_vec, row_vec, heads, n_win, seq, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// elt_bytes 2 (bf16) or 4 (f32); head_dim * elt_bytes / 16 a power of two
// from 1 to 32, and every pointer 16-byte aligned (the wrapper checks both).
// Returns a CUDA error code, or -1 for an element size it does not take.
extern "C" int aiis_window_qkv_unit(const void* qkv, void* q, void* k, void* v,
                                    const float* scale, long long batch, int n_win, int seq,
                                    int heads, int head_dim, int elt_bytes, float eps,
                                    void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elt_bytes == 2)
    return launch<__nv_bfloat16>(qkv, q, k, v, scale, batch, n_win, seq, heads, head_dim, eps, s);
  if (elt_bytes == 4)
    return launch<float>(qkv, q, k, v, scale, batch, n_win, seq, heads, head_dim, eps, s);
  return -1;
}
