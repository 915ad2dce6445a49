// Trailing rolling q-quantile at the last K positions of each row — the
// card's implementation of rolling_quantile_tail.
//
// Replaces the TPU kernel _qtail_kernel / rolling_quantile_tail_pallas
// (binquant_tpu/ops/pallas_rolling.py). Semantics are identical: for the
// output (row s, position k) the window is the L bars ending at column
// W-K+k; non-finite values (NaN, +-inf) are dropped by treating them as
// +inf; the order is by value with the column as tie-break; the lo/hi order
// statistics are interpolated linearly as pandas does; the result is NaN
// where the window holds fewer than min_periods finite values. Columns
// before the row start count as NaN (left padding when W < L+K-1).
//
// What bounds it on an H100: the function reads each row's last
// T = L+K-1 columns once and writes K outputs — at ActivityBurstPump's
// shape (S=2048, L=80, K=4) 0.71 MB, ~0.2 us of memory traffic, below one
// launch's latency. So the kernel is bound by latency and instruction
// issue, not by bytes, and matrix units (wgmma) or TMA have nothing to do:
// there is no product, and one row is a single short tile whose TMA load
// would only add an mbarrier round trip. What the design needs is one
// launch, one pass over device memory, enough resident warps, and no
// redundant ranking. The K windows of a row overlap in L-1 of their L
// columns, so the row's T (value, column) pairs are sorted ONCE and every
// window's order statistics are read from that one ordering:
//
//   * Sort. T <= 256 (ABP's T=83, SpikeHunter's T=60, a 96-tick backtest
//     chunk's T=179): one warp per row, kRowsPerBlock rows per block. The
//     warp loads the row's tail coalesced, R = 1, 2, 4 or 8 pairs per lane,
//     and bitonic-sorts the 32R pairs in registers with element
//     i = lane*R + r, so strides below R swap registers within the lane and
//     only strides >= R cost a __shfl_xor_sync (15 of the 28 steps at R=4).
//     256 < T <= kMaxSpan: one block per row sorts in shared memory.
//   * Select. The sorted pairs go to shared memory, beside the prefix count
//     of finite values in column order, so a window's finite count is one
//     subtraction. G lanes share a window (G = 32/K rounded down to a power
//     of two, at least 1): each counts the window's members
//     (k <= column < k+L) in its 1/G of the sorted pairs, a scan over the G
//     lanes gives each segment's first rank, and the lanes whose segments
//     hold ranks lo and hi walk them to those members. At K=4 that is 8
//     lanes per window and ~11 pairs per lane; at K=100 one lane per window
//     walks the sorted pairs once, all 32 windows of a round in lockstep
//     (shared-memory broadcasts). No second sort, no per-window ranking.
//
// Work per row falls from the count rank's O(K*L^2) to O(T log^2 T + K*T).
// Pairs past T are (+inf, a column >= T): they sort last and belong to no
// window. Values are compared as floats, never as bit patterns, so -0.0 and
// +0.0 tie and fall back to the column order, as in the twin's stable sort.
//
// Bit-exactness with the plain torch twin: the interpolation is written
// with __fadd_rn/__fsub_rn/__fmul_rn so nvcc cannot contract it into an
// FMA, and the order statistics are selected (not summed), so the result
// equals the twin's separate float32 operations bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libqtail.so qtail.cu

#include <cuda_runtime.h>
#include <math_constants.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 4;   // register path: one warp per row
constexpr int kBlockWarps = 8;     // shared-memory path: one block per row
constexpr int kMaxRegSpan = 256;   // 32 lanes x 8 pairs
constexpr int kMaxSpan = 4096;     // pairs + finite prefix stay under the 48 KB default

// (va, ca) orders before (vb, cb): by value, then by column
__device__ __forceinline__ bool ordered_before(float va, int ca, float vb, int cb) {
  return va < vb || (va == vb && ca < cb);
}

// tail column j of row s (j < T); NaN before the row start, non-finite as +inf
__device__ __forceinline__ float load_tail(const float* __restrict__ x, int s, int W,
                                           int T, int j) {
  const int col = W - T + j;
  const float raw = col >= 0 ? x[(long long)s * W + col] : CUDART_NAN_F;
  return isfinite(raw) ? raw : CUDART_INF_F;
}

// Every window's order statistics from one sorted row, by one warp.
//   sv, sc: the row's T (value, column) pairs in sorted order;
//   fin:    fin[j] = finite values among tail columns < j, for j <= T.
// G lanes share a window (G = 32 for K = 1, down to 1 for K >= 32). Each
// lane counts the window's members in its 1/G of the sorted pairs, a scan
// over the G lanes gives each segment's first rank, and the lanes whose
// segments hold rank lo or hi walk them again to find those members. The
// warp handles windows warp, warp + warps, ... (32/G of them per round).
__device__ __forceinline__ void select_windows(const float* sv, const int* sc,
                                               const unsigned short* fin, int T, int L,
                                               int K, float q, int mp, float* out_row,
                                               int warp, int warps) {
  const int lane = threadIdx.x & 31;
  int G = 32;
  while (G > 1 && 32 / G < K) G >>= 1;
  const int per_round = 32 / G;
  const int g = lane & (G - 1);
  const unsigned group = (G == 32 ? kFull : (1u << G) - 1u) << (lane & ~(G - 1));
  const int seg = (T + G - 1) / G;
  const int p0 = min(g * seg, T);
  const int p1 = min(p0 + seg, T);
  for (int k0 = warp * per_round; k0 < K; k0 += warps * per_round) {
    const int k = min(k0 + lane / G, K - 1);  // spare lanes repeat the last window
    const int cnt = fin[k + L] - fin[k];
    // the same float32 arithmetic as the twin: rank = q * (cnt - 1)
    const float rankf = __fmul_rn(q, __fsub_rn((float)cnt, 1.0f));
    int lo = (int)floorf(rankf);
    lo = lo < 0 ? 0 : (lo > L - 1 ? L - 1 : lo);
    int hi = lo + 1 > L - 1 ? L - 1 : lo + 1;
    hi = min(hi, max(cnt - 1, 0));
    const int last = max(lo, hi);

    int seen = 0;  // members of window k in the segments before this lane's
    if (G > 1) {
      int mine = 0;
      for (int p = p0; p < p1; ++p) mine += (unsigned)(sc[p] - k) < (unsigned)L;
      int incl = mine;
      for (int d = 1; d < G; d <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, d, G);
        if (g >= d) incl += t;
      }
      seen = incl - mine;
    }
    int p_lo = -1, p_hi = -1;
    for (int p = p0; p < p1 && seen <= last; ++p) {
      if ((unsigned)(sc[p] - k) < (unsigned)L) {
        if (seen == lo) p_lo = p;
        if (seen == hi) p_hi = p;
        ++seen;
      }
    }
    // exactly one lane of each group holds each of the two members
    const int src_lo = __ffs(__ballot_sync(kFull, p_lo >= 0) & group) - 1;
    const int src_hi = __ffs(__ballot_sync(kFull, p_hi >= 0) & group) - 1;
    const float v_lo = __shfl_sync(kFull, p_lo >= 0 ? sv[p_lo] : 0.0f, src_lo);
    const float v_hi = __shfl_sync(kFull, p_hi >= 0 ? sv[p_hi] : 0.0f, src_hi);
    if (g == 0 && k0 + lane / G < K) {
      // separately rounded, as the twin: nvcc may not contract this to an FMA
      const float frac = __fsub_rn(rankf, (float)lo);
      const float r = __fadd_rn(v_lo, __fmul_rn(__fsub_rn(v_hi, v_lo), frac));
      out_row[k] = cnt < mp ? CUDART_NAN_F : r;
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
qtail_warp_kernel(const float* __restrict__ x, float* __restrict__ out, int S, int W,
                  int L, int K, float q, int mp) {
  constexpr int kN = 32 * R;
  constexpr int kLogR = R == 1 ? 0 : R == 2 ? 1 : R == 4 ? 2 : 3;
  __shared__ float s_v[kRowsPerBlock][kN];
  __shared__ int s_c[kRowsPerBlock][kN];
  __shared__ unsigned short s_fin[kRowsPerBlock][kN + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kRowsPerBlock + warp;
  if (s >= S) return;  // whole warp exits together
  const int T = L + K - 1;
  const unsigned lanes_below = (1u << lane) - 1u;

  // coalesced load of columns r*32 + lane, with the finite prefix
  float v[R];
  int c[R];
  int finite_before = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * 32 + lane;
    c[r] = j;
    v[r] = j < T ? load_tail(x, s, W, T, j) : CUDART_INF_F;
    const unsigned f = __ballot_sync(kFull, v[r] < CUDART_INF_F);
    if (j < T) s_fin[warp][j] = (unsigned short)(finite_before + __popc(f & lanes_below));
    finite_before += __popc(f);
  }
  if (lane == 0) s_fin[warp][T] = (unsigned short)finite_before;

  // bitonic sort of the 32R pairs, element i = lane*R + r: strides below R
  // swap registers within the lane, larger strides exchange with lane
  // ^ (stride/R) by __shfl_xor_sync
#pragma unroll
  for (int ls = 1; ls <= kLogR + 5; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
      const int stride = 1 << lj;
      if (stride < R) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r & stride) continue;
          const int r2 = r | stride;
          const bool asc = (((lane << kLogR) | r) & size) == 0;
          if (ordered_before(v[r2], c[r2], v[r], c[r]) == asc) {
            const float tv = v[r]; v[r] = v[r2]; v[r2] = tv;
            const int tc = c[r]; c[r] = c[r2]; c[r2] = tc;
          }
        }
      } else {
        const int lane_stride = stride >> kLogR;
        // the lower of the pair keeps the first when ascending
        const bool keep_first =
            ((lane & lane_stride) == 0) == (((lane << kLogR) & size) == 0);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pv = __shfl_xor_sync(kFull, v[r], lane_stride);
          const int pc = __shfl_xor_sync(kFull, c[r], lane_stride);
          if (ordered_before(pv, pc, v[r], c[r]) == keep_first) {
            v[r] = pv;
            c[r] = pc;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s_v[warp][lane * R + r] = v[r];
    s_c[warp][lane * R + r] = c[r];
  }
  __syncwarp();
  select_windows(s_v[warp], s_c[warp], s_fin[warp], T, L, K, q, mp,
                 out + (long long)s * K, 0, 1);
}

__global__ void __launch_bounds__(kBlockWarps * 32)
qtail_block_kernel(const float* __restrict__ x, float* __restrict__ out, int S, int W,
                   int L, int K, float q, int mp, int N) {
  extern __shared__ float smem[];
  float* sv = smem;
  int* sc = reinterpret_cast<int*>(smem + N);
  unsigned short* fin = reinterpret_cast<unsigned short*>(sc + N);
  const int s = blockIdx.x;
  const int T = L + K - 1;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    sv[j] = j < T ? load_tail(x, s, W, T, j) : CUDART_INF_F;
    sc[j] = j;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // the finite prefix, 32 columns at a time
    const int lane = threadIdx.x;
    int finite_before = 0;
    for (int base = 0; base < T; base += 32) {
      const int j = base + lane;
      const unsigned f = __ballot_sync(kFull, j < T && sv[j] < CUDART_INF_F);
      if (j < T) fin[j] = (unsigned short)(finite_before + __popc(f & ((1u << lane) - 1u)));
      finite_before += __popc(f);
    }
    if (lane == 0) fin[T] = (unsigned short)finite_before;
  }
  __syncthreads();

  // bitonic sort of the N pairs in shared memory
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < N / 2; t += blockDim.x) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int p = i + stride;
        const bool asc = (i & size) == 0;
        if (ordered_before(sv[p], sc[p], sv[i], sc[i]) == asc) {
          const float tv = sv[i]; sv[i] = sv[p]; sv[p] = tv;
          const int tc = sc[i]; sc[i] = sc[p]; sc[p] = tc;
        }
      }
      __syncthreads();
    }
  }
  select_windows(sv, sc, fin, T, L, K, q, mp, out + (long long)s * K,
                 threadIdx.x >> 5, kBlockWarps);
}

template <int R>
void launch_warp(const float* x, float* out, int S, int W, int L, int K, float q, int mp,
                 cudaStream_t stream) {
  const int blocks = (S + kRowsPerBlock - 1) / kRowsPerBlock;
  qtail_warp_kernel<R><<<blocks, kRowsPerBlock * 32, 0, stream>>>(x, out, S, W, L, K, q, mp);
}

}  // namespace

// C interface for ctypes. Returns cudaGetLastError() after the launch
// (0 = launched); the caller allocates ``out`` (S, K), validates shapes and
// keeps L + K - 1 within qtail_max_span().
extern "C" int qtail_launch(const float* x, float* out, int S, int W, int L, int K,
                            float q, int mp, void* stream) {
  if (S <= 0 || K <= 0) return 0;
  const int T = L + K - 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (T <= 32) {
    launch_warp<1>(x, out, S, W, L, K, q, mp, st);
  } else if (T <= 64) {
    launch_warp<2>(x, out, S, W, L, K, q, mp, st);
  } else if (T <= 128) {
    launch_warp<4>(x, out, S, W, L, K, q, mp, st);
  } else if (T <= kMaxRegSpan) {
    launch_warp<8>(x, out, S, W, L, K, q, mp, st);
  } else if (T <= kMaxSpan) {
    int N = 2 * kMaxRegSpan;
    while (N < T) N <<= 1;
    const size_t smem = (size_t)N * (sizeof(float) + sizeof(int)) +
                        (size_t)(N + 1) * sizeof(unsigned short);
    qtail_block_kernel<<<S, kBlockWarps * 32, smem, st>>>(x, out, S, W, L, K, q, mp, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// the largest L + K - 1 the kernel takes
extern "C" int qtail_max_span() { return kMaxSpan; }
