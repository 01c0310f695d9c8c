// Query scores for Hopper (sm_90a): the cosine matvec and the BM25 comparison
// sweep of the normal-mode fused query, for up to 8 packed queries at once.
//
// Replaces the front of the XLA program anime_illust_image_searcher_tpu/ops/
// fused_query.py::_fused_final (:242-306), which XLA fuses into registers:
//     sims[b, d]      = sum_f matrix[d, f] * qvec[b, f]                  (:254)
//     bm25[b, d]      = sum_w contrib[d, w] * qw[b, q]  where term[d, w] == qids[b, q]
//                                                                        (:261-264)
//     excl_hits[b, d] = #slots w whose term matches an excluded query id  (:281-306)
//     req_hits[b, d]  = #slots w whose term matches a required query id
// The masks, the max-normalization, the fusion, the top-k and the rerank stay
// in PyTorch (ops/fused_query.py). No Pallas kernel existed here: the port
// writes this one because a plain PyTorch copy of :262 materialises the
// (D, W, Q) match tensor (1 GB in f32 at 1M docs, W=32, Q=8), or makes Q
// passes over the term matrix.
//
// With W = Q = 0 it still computes the sims alone; that route is the
// yardstick of the second kernel below, which the port launches instead.
//
// Inputs: matrix (D, F) f32 unit rows; term_mat (D, W) int32 padded with the
// sentinel vocab_size (term ids are >= 0); contrib_mat (D, W) f32 padded with
// 0; packed (B, buflen) f32, each row one pack_query() buffer [qids(Q) | qw(Q)
// | qexcl(Q) | qreq(Q) | qvec(F) | n_req] with the ids as int32 bit patterns
// biased by 2^30, Q <= 256 (ops/fused_query.py's largest term bucket). Within
// a query the ids are distinct, so a slot matches at most one of them; unused
// slots carry id -1, which no term matches. Outputs are (B, D) row-major.
//
// Bound: each doc row is read once for all B queries, 4F + 8W bytes, and the
// outputs are 16 bytes a (query, doc). At D=1M, F=300, W=32 that is 1.456 GB
// of reads, 0.435 ms at 3.35 TB/s, plus 16 MB of writes a query. With one row
// in flight a warp (plain loads, then the reduction, then the next row's
// loads) too few bytes were in flight for that rate, and each slot did B
// binary searches, one in each query's ids.
//
// Design:
//   block  = 8 consumer warps + 1 producer warp. The consumers copy the B
//            query vectors into shared memory (rows padded to a multiple of 4
//            floats, so float4 reads stay aligned), sort each query's ids with
//            their weights and exclude/require flags (rank sort), and build the
//            sorted union of the B id lists without duplicates or -1, each
//            entry with a B-bit mask of the queries that hold it and 8 bytes,
//            byte b the entry's slot in query b's sorted list (so Q <= 256).
//            An id's union index is the number of distinct ids below it: the
//            sum, over the lists, of the first occurrences before its
//            lower_bound there (no O((BQ)^2) rank sort over the union).
//   ring   = 2 stages of R doc rows each (R a multiple of 8 worked out from
//            the bytes of a row, up to about 16 KB a stage; 4 where 8 rows do
//            not fit beside the query data), one full and one empty mbarrier
//            a stage. Two stages, not four: bytes in flight were never short
//            (Little's law at 3.35 TB/s asks about 25 KB an SM, and 2 stages
//            of 4-5 blocks hold 90-120 KB), while the shared memory of more
//            stages cost blocks an SM, and the consumers' latency then showed.
//            The producer's lane 0 walks the block's tiles (tile t =
//            blockIdx.x + i * gridDim.x, R rows from row t * R; the grid
//            fills every SM); for each it waits on the stage's empty
//            barrier, sets expect_tx on its full barrier and issues 1-D
//            cp.async.bulk copies of the tile's R matrix rows, and, when
//            there is a sweep, its R term rows and R contribution rows
//            (R * F * 4 and R * W * 4 bytes: multiples of 16 for any F, W).
//            The last, ragged tile (D % R rows) and every tile of a matrix
//            whose base is not 16-byte aligned are filled by the consumers
//            with plain loads into the same layout, behind a named barrier:
//            the producer only hands them the stage (a plain arrive). That
//            tile is the block's last (ragged) or no tile of the launch is
//            bulk (alignment), so no stage takes both proxies' writes.
//   rows   : each consumer warp takes the tile's rows round-robin (rotated by
//            tile so that warps share the rows evenly when 8 does not divide
//            R), scores each row from shared memory, then arrives on the
//            stage's empty barrier.
//   sims   : lanes stride over F (float4 reads when F % 4 == 0 and the matrix
//            is 16-byte aligned), B partial sums a lane in registers. The
//            kernel is built for B = 1 (4 sums a lane) and for B = 2..8 (32),
//            so that one query does not pay the batch's registers.
//   sweep  : lanes stride over W; one binary search of each slot's term id in
//            the union (ceil(log2 |U|) steps, where each query's own search
//            took ceil(log2 Q) steps B times); on a hit, for each query in the
//            entry's mask, the entry's slot byte gives the id's weight and
//            flags, and the slot adds contrib * qw (product and sum rounded
//            separately, as in the JAX program) and counts its flags, written
//            out as int32 (the JAX program's base-2^k float encode of both
//            counts was an XLA trick to save a pass).
//   reduce : one fixed xor-shuffle tree over the warp. At B = 1 each of the 4
//            sums takes 5 shuffles and lane 0 writes. At B > 1 the 4 x 8 sums
//            (counts held as floats, exact below 2^24) are transpose-reduced
//            in 16 + 8 + 4 + 2 + 1 = 31 shuffles instead of 4 x 5 x B, and
//            lane L ends with sum L: output L >> 3 of query L & 7. Both forms
//            add the lanes in the same pairs (offsets 16, 8, 4, 2, 1), so a
//            query scores the same bits alone and in a batch.
// The order of every sum depends only on F, W and the row's contents, never
// on the row's index, tile, warp or block, so duplicate docs score
// bit-identically (the elbow cut maps a zero score difference to +inf and
// relies on it), and the outputs keep the bits of the one-row-a-warp kernel
// this design replaced. No atomics on the outputs.
//
// The second kernel, matvecs_kernel (C entries aiis_matvecs and
// aiis_matvecs_plan): out[b, d] = sum_f matrix[d, f] * vecs[b, f] for B <= 8
// f32 vectors, with no term slots. It replaces two XLA dots in full f32 (no
// TF32): the fused query's rerank product jnp.dot(matrix, mean,
// precision=HIGHEST) (anime_illust_image_searcher_tpu/ops/fused_query.py:357)
// and the character query's 1 - jnp.dot(m, q) (models/caformer.py:306, :329),
// at F=300 and F=768 over every doc row.
//   bound : a pure stream, 4 D F + 4 B F bytes read and 4 B D written: at
//           D=1M, F=768, B=1, 3.076 GB, 0.918 ms at 3.35 TB/s; its 2 B D F
//           FMA flops stay under 0.2 ms at 67 TFLOP/s even at B=8.
//   loads : no staging. Each row is read by one warp and used once, so a
//           shared-memory ring (the scoring kernel's cp.async.bulk tiles on
//           mbarriers) only adds a barrier round trip a tile and the set-up
//           of a sweep this job does not have. Each lane streams its rows with
//           16-byte ld.global.nc loads that skip L1 (scalar loads where F % 4
//           != 0 or the base is not 16-byte aligned), all R rows of its group
//           in flight at once: R = 32 / kB rows a warp group, 32 rows (16 KB a
//           warp a step at B=1), far past the ~25 KB an SM that Little's law
//           asks at 3.35 TB/s.
//   block : 8 warps; warp w of the grid takes groups w, w + 8 x grid, ...
//           (R rows each, the last ragged). The grid gives each warp the
//           fewest groups that stream 32 KB, so blocks are short-lived and
//           the hardware balances the SMs (a persistent grid's static split
//           left a tail).
//   query : the B vectors in shared memory, rows padded to a multiple of 4
//           floats, read as float4 a step and shared by the group's R rows.
//   sums  : kB in {1, 2, 4, 8} (B = 1, 2, 3..4, 5..8) slots, R x kB = 32
//           partial sums a lane: B a row, never the scoring kernel's 4 B.
//   store : one transpose-reduce of the 32 sums (31 shuffles, offsets 16, 8,
//           4, 2, 1) leaves lane L with sum L, query L / R, row L % R, so a
//           group's scores leave as runs of R consecutive floats: whole 128-
//           byte lines at B=1, 64 / 32 / 16 bytes at kB = 2 / 4 / 8.
// The arithmetic order is the scoring kernel's, so both give the same bits:
// lanes stride over F by float4 (or float), each lane's sum for query b
// updated by fmaf in the order x, y, z, w, then the xor tree over the warp at
// offsets 16, 8, 4, 2, 1. Only how the rows reach the lanes differs. Duplicate
// rows keep identical sums, and a query the same bits alone and in a batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace {

constexpr int kWarps = 8;                       // consumer warps
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;       // + the producer warp
constexpr int kMaxB = 8;
constexpr int kMaxQ = 256;                      // a slot's place in its query is a byte
constexpr int kIdBias = 0x40000000;
constexpr int kStages = 2;                      // ring stages
constexpr int kTileBytes = 16 * 1024;           // a stage's target size
constexpr int kStageAlign = 128;
constexpr int kHeader = 128;                    // 2 x kStages mbarriers, kMaxB totals
static_assert(16 * kStages + 4 * kMaxB <= kHeader, "header too small");

struct Args {
  const float* matrix;
  const int* term_mat;
  const float* contrib_mat;
  const float* packed;
  long long D;
  int F, W, Q, B, buflen;
  int rows;          // R: doc rows a tile
  int stage_bytes;   // bytes a stage (R rows, rounded up to kStageAlign)
  bool sweep;        // Q > 0 and W > 0: the term and contribution rows are staged
  bool bulk;         // full tiles come by cp.async.bulk (16-byte aligned bases)
  float* sims;
  float* bm25;
  int* excl_hits;
  int* req_hits;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}" ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One 1-D bulk copy global -> shared that completes `bytes` on the barrier.
// dst, src and bytes are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Named barrier 1: the 8 consumer warps only (the producer never waits on it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One step of the transpose-reduce: kN values a lane -> kN / 2, exchanged
// with the lane kN / 2 away. The lane with that bit set keeps the upper half.
template <int kN>
__device__ __forceinline__ void transpose_step(float (&v)[4 * kMaxB], int lane) {
  constexpr int kHalf = kN / 2;
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// The first index of the sorted a[0, n) whose value is >= x.
__device__ __forceinline__ int lower_bound(const int* a, int n, int x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The last index of the sorted a[0, n) (n >= 1) whose value is <= t, or 0:
// ceil(log2 n) dependent steps.
__device__ __forceinline__ int last_le(const int* a, int n, int t) {
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    base = (a[base + half] <= t) ? base + half : base;
    n -= half;
  }
  return base;
}

template <typename T>
__device__ __forceinline__ void fill(T* dst, const T* __restrict__ src, int n, int tid) {
  for (int k = tid; k < n; k += kConsumers) dst[k] = __ldg(src + k);
}

__host__ __device__ __forceinline__ int row_pitch(int F) { return (F + 3) & ~3; }

// qv (B x pitch f32) | wts, flags, union ids, union masks, ids, scratch (B x Q each)
size_t query_bytes(int B, int F, int Q) {
  return 4ull * (static_cast<size_t>(B) * row_pitch(F) + 6ull * B * Q);
}

// The producer: lane 0 of the last warp.
__device__ __forceinline__ void produce(const Args& a, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, long long ntiles) {
  const uint32_t mbytes = static_cast<uint32_t>(a.rows) * a.F * 4;
  const uint32_t wbytes = a.sweep ? static_cast<uint32_t>(a.rows) * a.W * 4 : 0u;
  int s = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    mbar_wait(empty + s, phase ^ 1u);           // the first round passes at once
    unsigned char* st = ring + static_cast<size_t>(s) * a.stage_bytes;
    const long long r0 = t * a.rows;
    if (a.bulk && r0 + a.rows <= a.D) {
      mbar_arrive_expect_tx(full + s, mbytes + 2 * wbytes);
      bulk_load(st, a.matrix + r0 * a.F, mbytes, full + s);
      if (a.sweep) {
        bulk_load(st + mbytes, a.term_mat + r0 * a.W, wbytes, full + s);
        bulk_load(st + mbytes + wbytes, a.contrib_mat + r0 * a.W, wbytes, full + s);
      }
    } else {
      mbar_arrive(full + s);                    // the consumers fill this tile
    }
    if (++s == kStages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

// kB = 1: one query (4 sums a lane); kB = 8: 2..8 queries (32 sums a lane).
template <bool kVec4, int kB>
__global__ void __launch_bounds__(kThreads) query_scores_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  int* totals = reinterpret_cast<int*>(empty + kStages);
  unsigned char* ring = smem + kHeader;
  const int B = a.B, Q = a.Q, F = a.F, W = a.W, BQ = B * Q;
  const int pitch = row_pitch(F);
  float* qv = reinterpret_cast<float*>(ring + static_cast<size_t>(kStages) * a.stage_bytes);
  float* wts = qv + B * pitch;
  int* flags = reinterpret_cast<int*>(wts + BQ);
  int* uid = flags + BQ;           // the sorted union of the ids
  unsigned* umask = reinterpret_cast<unsigned*>(uid + BQ);
  int* ids = reinterpret_cast<int*>(umask + BQ);
  int* scratch = ids + BQ;         // raw ids, then first-occurrence prefix counts
  // once the union is built: 8 bytes a union entry, byte b the entry's slot in
  // query b's sorted lists (ids and scratch are dead by then)
  unsigned char* upos = reinterpret_cast<unsigned char*>(ids);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long ntiles = (a.D + a.rows - 1) / a.rows;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == kWarps) {            // the producer starts loading during the set-up
    if (lane == 0) produce(a, ring, full, empty, ntiles);
    return;
  }

  // ---- set-up, consumers only: query vectors, sorted ids, their union
  for (int i = tid; i < B * F; i += kConsumers) {
    const int b = i / F, f = i - b * F;
    qv[b * pitch + f] = a.packed[static_cast<size_t>(b) * a.buflen + 4 * Q + f];
  }
  for (int i = tid; i < BQ; i += kConsumers) {
    const int b = i / Q, j = i - b * Q;
    scratch[i] = __float_as_int(a.packed[static_cast<size_t>(b) * a.buflen + j]) - kIdBias;
    umask[i] = 0u;
  }
  consumers_sync();
  // rank sort of each query's ids (ties, i.e. the -1 of unused slots, by slot)
  for (int i = tid; i < BQ; i += kConsumers) {
    const int b = i / Q, j = i - b * Q;
    const int* row = scratch + b * Q;
    const int id = row[j];
    int rank = 0;
    for (int k = 0; k < Q; ++k) {
      const int o = row[k];
      rank += (o < id) | ((o == id) & (k < j));
    }
    const float* pb = a.packed + static_cast<size_t>(b) * a.buflen;
    ids[b * Q + rank] = id;
    wts[b * Q + rank] = pb[Q + j];
    flags[b * Q + rank] = (pb[2 * Q + j] != 0.f ? 1 : 0) | (pb[3 * Q + j] != 0.f ? 2 : 0);
  }
  consumers_sync();
  // an id's first occurrence: not -1, and in no earlier query's list
  for (int i = tid; i < BQ; i += kConsumers) {
    const int b = i / Q, j = i - b * Q, x = ids[i];
    bool first = x != -1 && (j == 0 || ids[i - 1] != x);
    for (int c = 0; c < b && first; ++c) {
      const int k = lower_bound(ids + c * Q, Q, x);
      first = !(k < Q && ids[c * Q + k] == x);
    }
    scratch[i] = first ? 1 : 0;
  }
  consumers_sync();
  if (warp < B) {                  // warp b: exclusive prefix counts of list b
    int* pf = scratch + warp * Q;
    int carry = 0;
    for (int j0 = 0; j0 < Q; j0 += 32) {
      const int j = j0 + lane;
      const int f = j < Q ? pf[j] : 0;
      const unsigned bits = __ballot_sync(0xffffffffu, f != 0);
      if (j < Q) pf[j] = carry + __popc(bits & ((1u << lane) - 1u));
      carry += __popc(bits);
    }
    if (lane == 0) totals[warp] = carry;
  }
  consumers_sync();
  for (int i = tid; i < BQ; i += kConsumers) {
    const int b = i / Q, j = i - b * Q, x = ids[i];
    if (x == -1) continue;
    int u = 0;                     // the number of distinct ids below x
    for (int c = 0; c < B; ++c) {
      const int k = lower_bound(ids + c * Q, Q, x);
      u += k < Q ? scratch[c * Q + k] : totals[c];
    }
    uid[u] = x;                    // every holder of x writes the same value
    atomicOr(umask + u, 1u << b);
    if (j == Q - 1 || ids[i + 1] != x) flags[i] |= (u + 1) << 2;   // u, until upos holds it
  }
  consumers_sync();
  for (int i = tid; i < BQ; i += kConsumers) {
    const int b = i / Q, j = i - b * Q, u1 = flags[i] >> 2;
    if (u1 != 0) {
      upos[8 * (u1 - 1) + b] = static_cast<unsigned char>(j);
      flags[i] &= 3;
    }
  }
  int n_union = 0;
  for (int c = 0; c < B; ++c) n_union += totals[c];
  consumers_sync();

  // ---- the ring: score each staged row
  const int mfloats = a.rows * F;
  const int wints = a.sweep ? a.rows * W : 0;
  int s = 0;
  uint32_t phase = 0;
  long long i = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    mbar_wait(full + s, phase);
    float* mt = reinterpret_cast<float*>(ring + static_cast<size_t>(s) * a.stage_bytes);
    int* tt = reinterpret_cast<int*>(mt + mfloats);
    float* ct = reinterpret_cast<float*>(tt + wints);
    const long long r0 = t * a.rows;
    const int n = a.D - r0 < a.rows ? static_cast<int>(a.D - r0) : a.rows;
    if (!a.bulk || n < a.rows) {   // a tile the bulk copy cannot take
      fill(mt, a.matrix + r0 * F, n * F, tid);
      if (a.sweep) {
        fill(tt, a.term_mat + r0 * W, n * W, tid);
        fill(ct, a.contrib_mat + r0 * W, n * W, tid);
      }
      consumers_sync();
    }
    for (int r = (warp - static_cast<int>((i * a.rows) & (kWarps - 1)) + kWarps) & (kWarps - 1);
         r < n; r += kWarps) {
      const long long d = r0 + r;
      // v[b] sims, v[kB + b] bm25, v[2 kB + b] excluded hits, v[3 kB + b] required hits
      float v[4 * kB];
#pragma unroll
      for (int j = 0; j < 4 * kB; ++j) v[j] = 0.f;

      const float* row = mt + r * F;
      if (kVec4) {
        const float4* row4 = reinterpret_cast<const float4*>(row);
        for (int f4 = lane; f4 < F / 4; f4 += 32) {
          const float4 m = row4[f4];
#pragma unroll
          for (int b = 0; b < kB; ++b) {
            if (b < B) {
              const float4 q = *reinterpret_cast<const float4*>(qv + b * pitch + 4 * f4);
              v[b] = fmaf(m.x, q.x, v[b]);
              v[b] = fmaf(m.y, q.y, v[b]);
              v[b] = fmaf(m.z, q.z, v[b]);
              v[b] = fmaf(m.w, q.w, v[b]);
            }
          }
        }
      } else {
        for (int f = lane; f < F; f += 32) {
          const float m = row[f];
#pragma unroll
          for (int b = 0; b < kB; ++b) {
            if (b < B) v[b] = fmaf(m, qv[b * pitch + f], v[b]);
          }
        }
      }

      // no ids in the union (Q = 0: the rerank and 1 - cos form) skips the sweep
      const int* trow = tt + r * W;
      const float* crow = ct + r * W;
      for (int w = lane; n_union > 0 && w < W; w += 32) {
        const int term = trow[w];
        const int u = last_le(uid, n_union, term);
        if (uid[u] == term) {
          const float c = crow[w];
          const unsigned held = umask[u];
          const uint2 slots = reinterpret_cast<const uint2*>(upos)[u];
#pragma unroll
          for (int b = 0; b < kB; ++b) {
            if ((held >> b) & 1u) {
              const int p = b * Q + (((b < 4 ? slots.x : slots.y) >> (8 * (b & 3))) & 0xff);
              v[kB + b] = __fadd_rn(v[kB + b], __fmul_rn(c, wts[p]));
              const int fl = flags[p];
              v[2 * kB + b] += static_cast<float>(fl & 1);
              v[3 * kB + b] += static_cast<float>(fl >> 1);
            }
          }
        }
      }

      if constexpr (kB == 1) {
        const float vs = warp_sum(v[0]);
        const float vb = warp_sum(v[1]);
        const float ve = warp_sum(v[2]);
        const float vr = warp_sum(v[3]);
        if (lane == 0) {
          a.sims[d] = vs;
          a.bm25[d] = vb;
          a.excl_hits[d] = static_cast<int>(ve);
          a.req_hits[d] = static_cast<int>(vr);
        }
      } else {
        transpose_step<32>(v, lane);
        transpose_step<16>(v, lane);
        transpose_step<8>(v, lane);
        transpose_step<4>(v, lane);
        transpose_step<2>(v, lane);
        const int b = lane & (kMaxB - 1);
        if (b < B) {
          const size_t o = static_cast<size_t>(b) * a.D + d;
          switch (lane >> 3) {
            case 0: a.sims[o] = v[0]; break;
            case 1: a.bm25[o] = v[0]; break;
            case 2: a.excl_hits[o] = static_cast<int>(v[0]); break;
            default: a.req_hits[o] = static_cast<int>(v[0]); break;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (++s == kStages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

// The ring's shape: kStages stages of R rows, R the multiple of 8 (a row for
// each consumer warp) nearest below kTileBytes of rows, at least 8; R drops to
// 4 where 8 rows do not fit beside the query data.
struct Plan {
  int rows = 0, stage_bytes = 0;
  size_t smem = 0;
};

bool make_plan(int F, int W, int Q, int B, size_t max_smem, Plan* plan) {
  const bool sweep = Q > 0 && W > 0;
  const size_t row = 4ull * F + (sweep ? 8ull * W : 0ull);
  const size_t fit = kTileBytes / (kWarps * row) * kWarps;
  for (const size_t rows : {fit > kWarps ? fit : static_cast<size_t>(kWarps),
                            static_cast<size_t>(4)}) {
    const size_t stage = (rows * row + kStageAlign - 1) / kStageAlign * kStageAlign;
    const size_t smem = kHeader + kStages * stage + query_bytes(B, F, Q);
    if (smem <= max_smem) {
      plan->rows = static_cast<int>(rows);
      plan->stage_bytes = static_cast<int>(stage);
      plan->smem = smem;
      return true;
    }
  }
  return false;
}

// The SM count and the shared memory a block may opt into are read once a
// device. The blocks an SM holds depend on the kernel form and its dynamic
// shared memory, so they are worked out once for each (device, form, shared
// memory) and kept: later launches of that shape make no attribute or
// occupancy query. Past 48 KB of dynamic shared memory the kernel must be
// allowed more first; the allowance only ever grows, so a smaller shape
// launched after a larger one stays within it.
struct DeviceInfo {
  int sms = 0;
  size_t max_smem = 0;
  size_t allowed[4] = {0, 0, 0, 0};     // by kernel form: 2 kVec4 + (kB == 1)
  std::map<size_t, int> per_sm[4];
};

template <bool kVec4, int kB>
cudaError_t configure(int F, int W, int Q, int B, Plan* plan, int* sms, int* per_sm) {
  constexpr int form = 2 * kVec4 + (kB == 1);
  static std::mutex mu;
  static std::map<int, DeviceInfo> infos;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  DeviceInfo& info = infos[device];
  if (info.sms == 0) {
    int sm_count = 0, optin = 0;
    err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    info.sms = sm_count;
    info.max_smem = static_cast<size_t>(optin);
  }
  if (!make_plan(F, W, Q, B, info.max_smem, plan)) return cudaErrorInvalidValue;
  *sms = info.sms;
  if (plan->smem > 48 * 1024 && plan->smem > info.allowed[form]) {
    err = cudaFuncSetAttribute(query_scores_kernel<kVec4, kB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(plan->smem));
    if (err != cudaSuccess) return err;
    info.allowed[form] = plan->smem;
  }
  const auto it = info.per_sm[form].find(plan->smem);
  if (it != info.per_sm[form].end()) {
    *per_sm = it->second;
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, query_scores_kernel<kVec4, kB>,
                                                      kThreads, plan->smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  info.per_sm[form].emplace(plan->smem, *per_sm);
  return cudaSuccess;
}

template <bool kVec4, int kB>
int launch(Args a, cudaStream_t stream, int* report) {
  Plan plan;
  int sms = 0, per_sm = 0;
  const cudaError_t err = configure<kVec4, kB>(a.F, a.W, a.Q, a.B, &plan, &sms, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.rows = plan.rows;
  a.stage_bytes = plan.stage_bytes;
  const long long ntiles = (a.D + plan.rows - 1) / plan.rows;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(ntiles < resident ? ntiles : resident);
  if (report) {
    report[0] = plan.rows;
    report[1] = kStages;
    report[2] = static_cast<int>(plan.smem);
    report[3] = per_sm;
    report[4] = grid;
    return 0;
  }
  query_scores_kernel<kVec4, kB><<<grid, kThreads, plan.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int dispatch(const void* matrix, const void* term_mat, const void* contrib_mat,
             const void* packed, long long D, int F, int W, int Q, int B, void* sims,
             void* bm25, void* excl_hits, void* req_hits, void* stream, int* report) {
  if (D < 1 || F < 1 || W < 0 || Q < 0 || Q > kMaxQ || B < 1 || B > kMaxB)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.matrix = static_cast<const float*>(matrix);
  a.term_mat = static_cast<const int*>(term_mat);
  a.contrib_mat = static_cast<const float*>(contrib_mat);
  a.packed = static_cast<const float*>(packed);
  a.D = D;
  a.F = F;
  a.W = W;
  a.Q = Q;
  a.B = B;
  a.buflen = 4 * Q + F + 1;
  a.sweep = Q > 0 && W > 0;
  a.bulk = aligned16(matrix) && (!a.sweep || (aligned16(term_mat) && aligned16(contrib_mat)));
  a.sims = static_cast<float*>(sims);
  a.bm25 = static_cast<float*>(bm25);
  a.excl_hits = static_cast<int*>(excl_hits);
  a.req_hits = static_cast<int*>(req_hits);
  const bool vec4 = (F % 4 == 0) && aligned16(matrix);
  auto* st = static_cast<cudaStream_t>(stream);
  if (B == 1) return vec4 ? launch<true, 1>(a, st, report) : launch<false, 1>(a, st, report);
  return vec4 ? launch<true, kMaxB>(a, st, report) : launch<false, kMaxB>(a, st, report);
}

// ---- matvecs_kernel: the sims alone, for B <= 8 vectors (the header's second kernel)

constexpr int kMvWarps = 8;
constexpr int kMvThreads = kMvWarps * 32;
constexpr long long kMvWarpBytes = 32 * 1024;   // matrix bytes a warp streams, at least, a block
// partial sums a lane, rows x query slots: the 32 that transpose_step takes
constexpr int kMvSums = 4 * kMaxB;

// A 16-byte load of a matrix row, read once: no L1 line. (An L2::256B
// prefetch hint cost 8% on an H100 at F=300, whose 1200-byte rows cross
// 256-byte blocks.) volatile: the compiler must not speculate a load past a
// ragged group's end.
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// One warp group's partial sums: v[b * R + r] for row r of `rows` and query
// b, R = kMvSums / kB rows (n of them real; kFull: all R). All R rows' loads
// of a step are issued before its FMAs.
template <bool kVec4, int kB, bool kFull>
__device__ __forceinline__ void group_sums(const float* __restrict__ rows, const float* qv,
                                           int pitch, int F, int B, int n, int lane,
                                           float (&v)[kMvSums]) {
  constexpr int R = kMvSums / kB;
  if constexpr (kVec4) {
    const int n4 = F >> 2;
    const float4* rows4 = reinterpret_cast<const float4*>(rows);
    for (int f4 = lane; f4 < n4; f4 += 32) {
      float4 m[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        m[r] = (kFull || r < n) ? ld_stream(rows4 + static_cast<size_t>(r) * n4 + f4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (b < B) {
          const float4 q = *reinterpret_cast<const float4*>(qv + b * pitch + 4 * f4);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float& s = v[b * R + r];
            s = fmaf(m[r].x, q.x, s);
            s = fmaf(m[r].y, q.y, s);
            s = fmaf(m[r].z, q.z, s);
            s = fmaf(m[r].w, q.w, s);
          }
        }
      }
    }
  } else {
    for (int f = lane; f < F; f += 32) {
      float m[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        m[r] = (kFull || r < n) ? ld_stream(rows + static_cast<size_t>(r) * F + f) : 0.f;
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (b < B) {
          const float q = qv[b * pitch + f];
#pragma unroll
          for (int r = 0; r < R; ++r) v[b * R + r] = fmaf(m[r], q, v[b * R + r]);
        }
      }
    }
  }
}

// Warp w of the grid takes groups w, w + 8 x grid, ... (R rows each, the
// last ragged).
template <bool kVec4, int kB>
__global__ void __launch_bounds__(kMvThreads) matvecs_kernel(const float* __restrict__ matrix,
                                                             const float* __restrict__ vecs,
                                                             long long D, int F, int B,
                                                             float* __restrict__ out) {
  constexpr int R = kMvSums / kB;
  extern __shared__ __align__(16) float mv_query[];    // B x pitch
  const int pitch = row_pitch(F);
  for (int i = threadIdx.x; i < B * F; i += kMvThreads) {
    const int b = i / F;
    mv_query[b * pitch + (i - b * F)] = vecs[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long groups = (D + R - 1) / R;
  const long long stride = static_cast<long long>(gridDim.x) * kMvWarps;
  for (long long g = static_cast<long long>(blockIdx.x) * kMvWarps + (threadIdx.x >> 5);
       g < groups; g += stride) {
    const long long d0 = g * R;
    const int n = D - d0 < R ? static_cast<int>(D - d0) : R;
    const float* rows = matrix + d0 * F;
    float v[kMvSums];
#pragma unroll
    for (int j = 0; j < kMvSums; ++j) v[j] = 0.f;
    if (n == R) {
      group_sums<kVec4, kB, true>(rows, mv_query, pitch, F, B, n, lane, v);
    } else {
      group_sums<kVec4, kB, false>(rows, mv_query, pitch, F, B, n, lane, v);
    }
    // the scoring kernel's pairs (offsets 16, 8, 4, 2, 1): lane L ends with
    // sum L, query L / R, row L % R
    transpose_step<32>(v, lane);
    transpose_step<16>(v, lane);
    transpose_step<8>(v, lane);
    transpose_step<4>(v, lane);
    transpose_step<2>(v, lane);
    const int b = lane / R, r = lane % R;
    if (b < B && r < n) out[static_cast<size_t>(b) * D + d0 + r] = v[0];
  }
}

// Past 48 KB of shared memory (B x F past 12,288 floats) the kernel form
// must be allowed more first, once a device; the allowance only grows, so a
// smaller shape launched after a larger one stays within it.
template <bool kVec4, int kB>
cudaError_t mv_allow(size_t smem) {
  static std::mutex mu;
  static std::map<int, size_t> allowed;      // by device
  if (smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& now = allowed[device];
  if (smem <= now) return cudaSuccess;
  err = cudaFuncSetAttribute(matvecs_kernel<kVec4, kB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) now = smem;
  return err;
}

template <bool kVec4, int kB>
int mv_launch(const float* matrix, const float* vecs, long long D, int F, int B, float* out,
              cudaStream_t stream, int* report) {
  constexpr int R = kMvSums / kB;
  const size_t smem = 4ull * B * row_pitch(F);
  cudaError_t err = mv_allow<kVec4, kB>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // A grid of short-lived blocks, not a persistent one: the hardware hands
  // each SM a new block as one ends, where a persistent grid's static split
  // of the groups left a tail (2% on an H100 at F=768, B=8). Each warp still
  // takes the fewest groups that stream kMvWarpBytes, so that a narrow
  // matrix's small groups (4 rows of 1200 bytes at F=300, kB=8) do not pay a
  // block's start, the query copy and its barrier, every few KB (17% there at
  // one group a warp).
  const long long group_bytes = 4ll * R * F;
  const int per_warp = static_cast<int>((kMvWarpBytes + group_bytes - 1) / group_bytes);
  const long long groups = (D + R - 1) / R;
  const long long blocks = (groups + kMvWarps * per_warp - 1) / (kMvWarps * per_warp);
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(blocks);
  if (report) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, matvecs_kernel<kVec4, kB>,
                                                        kMvThreads, smem);
    report[0] = R;
    report[1] = per_warp;
    report[2] = static_cast<int>(smem);
    report[3] = per_sm;
    report[4] = grid;
    return static_cast<int>(err);
  }
  matvecs_kernel<kVec4, kB><<<grid, kMvThreads, smem, stream>>>(matrix, vecs, D, F, B, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec4>
int mv_by_batch(const float* matrix, const float* vecs, long long D, int F, int B, float* out,
                cudaStream_t stream, int* report) {
  if (B == 1) return mv_launch<kVec4, 1>(matrix, vecs, D, F, B, out, stream, report);
  if (B == 2) return mv_launch<kVec4, 2>(matrix, vecs, D, F, B, out, stream, report);
  if (B <= 4) return mv_launch<kVec4, 4>(matrix, vecs, D, F, B, out, stream, report);
  return mv_launch<kVec4, kMaxB>(matrix, vecs, D, F, B, out, stream, report);
}

int mv_dispatch(const void* matrix, const void* vecs, long long D, int F, int B, void* out,
                void* stream, int* report) {
  if (D < 1 || F < 1 || B < 1 || B > kMaxB) return static_cast<int>(cudaErrorInvalidValue);
  const auto* m = static_cast<const float*>(matrix);
  const auto* q = static_cast<const float*>(vecs);
  auto* o = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if ((F % 4 == 0) && aligned16(matrix)) return mv_by_batch<true>(m, q, D, F, B, o, st, report);
  return mv_by_batch<false>(m, q, D, F, B, o, st, report);
}

}  // namespace

// Returns 0 or a cudaError_t. The wrapper (ops/query_scores.py) checks shapes,
// types, contiguity and B in 1..8 before it calls this.
extern "C" int aiis_query_scores(
    const void* matrix, const void* term_mat, const void* contrib_mat, const void* packed,
    long long D, int F, int W, int Q, int B,
    void* sims, void* bm25, void* excl_hits, void* req_hits, void* stream) {
  return dispatch(matrix, term_mat, contrib_mat, packed, D, F, W, Q, B, sims, bm25, excl_hits,
                  req_hits, stream, nullptr);
}

// The launch aiis_query_scores would make for these arguments, without
// making it: report = {R rows a stage, stages, dynamic shared memory bytes a
// block, blocks an SM, grid}. For measurement scripts; returns 0 or a
// cudaError_t.
extern "C" int aiis_query_scores_plan(
    const void* matrix, const void* term_mat, const void* contrib_mat,
    long long D, int F, int W, int Q, int B, int* report) {
  return dispatch(matrix, term_mat, contrib_mat, nullptr, D, F, W, Q, B, nullptr, nullptr,
                  nullptr, nullptr, nullptr, report);
}

// out (B, D) = vecs (B, F) . matrix (D, F)^T for B in 1..8, f32, row-major and
// contiguous. Returns 0 or a cudaError_t; the wrapper (ops/query_scores.py
// matvecs) checks shapes, types, contiguity and B before it calls this.
extern "C" int aiis_matvecs(const void* matrix, const void* vecs, long long D, int F, int B,
                            void* out, void* stream) {
  return mv_dispatch(matrix, vecs, D, F, B, out, stream, nullptr);
}

// The launch aiis_matvecs would make for these arguments, without making it:
// report = {R rows a warp group, groups a warp a block, dynamic shared memory
// bytes a block, blocks an SM, grid}. For measurement scripts; returns 0 or a
// cudaError_t.
extern "C" int aiis_matvecs_plan(const void* matrix, long long D, int F, int B, int* report) {
  return mv_dispatch(matrix, nullptr, D, F, B, nullptr, nullptr, report);
}
