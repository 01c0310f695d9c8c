// Shifted-window partition and its inverse for Hopper (sm_90a): the cyclic
// shift and the window partition of a SwinV2 block in one pass each.
//
// Replaces no Pallas kernel: the JAX package has no SwinV2. The port adds it
// because the plain route, torch.roll followed by the partition's permute
// copy, moves every activation of a block four times where one read and one
// write do (models/swinv2.py, ops/window_shift.py).
//
//   partition: x (B, R, R, C) tokens in row-major (row, col) order, rolled by
//              -shift on both spatial axes, then cut into (R/w)^2 windows of
//              w*w tokens: out (B, nW, S, C) contiguous, S = w*w, window
//              (wh, ww) = wh * (R/w) + ww, token (i, j) = i * w + j, and
//              out[b, window, token] = x[b, (wh*w + i + shift) % R,
//                                             (ww*w + j + shift) % R].
//   reverse:   the inverse, rolled back by +shift: y (B, nW, S, C) with any
//              row strides (the window attention hands its output over in
//              the (B, S, nW, C) order SDPA left it in) -> out (B, R, R, C)
//              contiguous.
//
// Bound: bytes. Each reads B*R*R*C elements once and writes them once; at
// stage 1 of SwinV2-B at 448 and B=256 that is 0.82 GB each way in bf16,
// 0.49 ms at 3.35 TB/s. Design: one thread a 16-byte vector of a token's row
// (8 bf16 or 4 f32; narrower vectors where a row or a base is not 16-byte
// aligned), threads in output order, so the writes are coalesced and each
// token's row is read as one contiguous run of vectors. The index arithmetic
// is ops/window_shift._source_rows's, which the CPU route and the tests use.
// No shared memory: a token moves as a whole row, so there is no transpose to
// stage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void window_shift_partition_kernel(const V* __restrict__ x, V* __restrict__ out,
                                              long long n_vec, int row_vec, int res,
                                              int window, int shift) {
  const int per_side = res / window;
  const long long tokens = (long long)res * res;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < n_vec;
       g += (long long)gridDim.x * blockDim.x) {
    const long long row = g / row_vec;
    const int v = (int)(g - row * row_vec);
    const long long b = row / tokens;
    const int p = (int)(row - b * tokens);        // (window, token) position
    const int w = p / (window * window), t = p - w * window * window;
    const int wh = w / per_side, ww = w - wh * per_side;
    const int i = t / window, j = t - i * window;
    int r = wh * window + i + shift, c = ww * window + j + shift;
    r -= r >= res ? res : 0;
    c -= c >= res ? res : 0;
    out[g] = x[(b * tokens + (long long)r * res + c) * row_vec + v];
  }
}

template <typename V>
__global__ void window_shift_reverse_kernel(const V* __restrict__ y, V* __restrict__ out,
                                            long long n_vec, int row_vec, int res, int window,
                                            int shift, long long sb, long long sw,
                                            long long st) {
  const int per_side = res / window;
  const long long tokens = (long long)res * res;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < n_vec;
       g += (long long)gridDim.x * blockDim.x) {
    const long long row = g / row_vec;
    const int v = (int)(g - row * row_vec);
    const long long b = row / tokens;
    const int p = (int)(row - b * tokens);        // (row, col) of the output token
    int r = p / res - shift, c = p % res - shift;
    r += r < 0 ? res : 0;
    c += c < 0 ? res : 0;
    const int wh = r / window, i = r - wh * window;
    const int ww = c / window, j = c - ww * window;
    const long long w = wh * per_side + ww, t = i * window + j;
    out[g] = y[b * sb + w * sw + t * st + v];
  }
}

// the widest vector that divides the row's bytes, the bases and the strides
int vector_bytes(long long row_bytes, uintptr_t bases, long long strides) {
  for (int vb = 16; vb > 1; vb /= 2)
    if (row_bytes % vb == 0 && bases % vb == 0 && strides % vb == 0) return vb;
  return 1;
}

int blocks_for(long long n_vec) {
  const long long threads = 256, most = 132LL * 16;   // 16 blocks an SM, grid-stride
  long long blocks = (n_vec + threads - 1) / threads;
  return (int)(blocks < most ? blocks : most);
}

template <typename V>
int partition(const void* x, void* out, long long batch, int res, int window, int shift,
              long long row_bytes, cudaStream_t stream) {
  const int row_vec = (int)(row_bytes / sizeof(V));
  const long long n_vec = batch * res * res * row_vec;
  window_shift_partition_kernel<V><<<blocks_for(n_vec), 256, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(out), n_vec, row_vec, res, window, shift);
  return (int)cudaGetLastError();
}

template <typename V>
int reverse(const void* y, void* out, long long batch, int res, int window, int shift,
            long long row_bytes, long long sb, long long sw, long long st,
            cudaStream_t stream) {
  const int row_vec = (int)(row_bytes / sizeof(V));
  const long long n_vec = batch * res * res * row_vec;
  const long long vb = sizeof(V);
  window_shift_reverse_kernel<V><<<blocks_for(n_vec), 256, 0, stream>>>(
      static_cast<const V*>(y), static_cast<V*>(out), n_vec, row_vec, res, window, shift,
      sb / vb, sw / vb, st / vb);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out contiguous; row_bytes = C * element size. Returns a CUDA error code.
extern "C" int aiis_window_shift_partition(const void* x, void* out, long long batch, int res,
                                           int window, int shift, long long row_bytes,
                                           void* stream) {
  if (batch <= 0 || res <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vector_bytes(row_bytes, (uintptr_t)x | (uintptr_t)out, 0)) {
    case 16: return partition<uint4>(x, out, batch, res, window, shift, row_bytes, s);
    case 8: return partition<uint2>(x, out, batch, res, window, shift, row_bytes, s);
    case 4: return partition<unsigned int>(x, out, batch, res, window, shift, row_bytes, s);
    case 2: return partition<unsigned short>(x, out, batch, res, window, shift, row_bytes, s);
    default: return partition<unsigned char>(x, out, batch, res, window, shift, row_bytes, s);
  }
}

// y's strides sb (image), sw (window), st (token) in bytes; out contiguous.
extern "C" int aiis_window_shift_reverse(const void* y, void* out, long long batch, int res,
                                         int window, int shift, long long row_bytes,
                                         long long sb, long long sw, long long st,
                                         void* stream) {
  if (batch <= 0 || res <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vector_bytes(row_bytes, (uintptr_t)y | (uintptr_t)out, sb | sw | st)) {
    case 16: return reverse<uint4>(y, out, batch, res, window, shift, row_bytes, sb, sw, st, s);
    case 8: return reverse<uint2>(y, out, batch, res, window, shift, row_bytes, sb, sw, st, s);
    case 4:
      return reverse<unsigned int>(y, out, batch, res, window, shift, row_bytes, sb, sw, st, s);
    case 2:
      return reverse<unsigned short>(y, out, batch, res, window, shift, row_bytes, sb, sw, st,
                                     s);
    default:
      return reverse<unsigned char>(y, out, batch, res, window, shift, row_bytes, sb, sw, st,
                                    s);
  }
}
