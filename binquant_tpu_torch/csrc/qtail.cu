// Trailing rolling q-quantile at the last K positions of each row — the
// card's implementation of rolling_quantile_tail.
//
// Replaces the TPU kernel _qtail_kernel / rolling_quantile_tail_pallas
// (binquant_tpu/ops/pallas_rolling.py). Semantics are identical: for the
// output (row s, position k) the window is the L bars ending at column
// W-K+k; non-finite values (NaN, +-inf) are dropped by treating them as
// +inf; the lo/hi order statistics are found by count-rank with the index
// as tie-break; the two are interpolated linearly as pandas does; the
// result is NaN where the window holds fewer than min_periods finite
// values. Columns before the row start count as NaN (left padding when
// W < L+K-1).
//
// What bounds it on an H100: at ActivityBurstPump's shape (S=2048, a
// 128-bar input of which the last L+K-1 = 83 columns are read, L=80, K=4)
// the function must read ~0.68 MB and write 32 KB: ~0.2 us of memory
// traffic, its bound (selecting two order statistics needs only O(L)
// comparisons per window, far less). This design spends more: its count
// rank does S*K*L^2 ~ 52 M compare-accumulates, ~0.8 us at the FP32 rate.
// Both are far below a launch's latency of a few microseconds, so the
// kernel is latency-bound. The design answers that with one
// warp per (row, k) output — S*K = 8192 warps fill all 132 SMs — the
// window staged once in shared memory, each lane ranking L/32 elements by
// an O(L) scan of shared memory (no sort, no global traffic inside the
// loop), and a single launch for all rows with no host synchronisation.
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
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void qtail_kernel(const float* __restrict__ x, float* __restrict__ out,
                             int S, int W, int L, int K, float q, int mp) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (task >= (long long)S * K) return;  // whole warp exits together
  const int s = (int)(task / K);
  const int k = (int)(task % K);

  // per-warp slice: L window values, then the lo/hi selections
  float* win = smem + warp * (L + 2);
  float* sel = win + L;

  // window [end-L+1, end] in row coordinates; columns < 0 are NaN padding
  const int end = W - K + k;
  const int start = end - L + 1;
  const float* row = x + (long long)s * W;
  int finite_cnt = 0;
  for (int i = lane; i < L; i += 32) {
    const int col = start + i;
    float v = (col >= 0) ? row[col] : CUDART_NAN_F;
    const bool fin = isfinite(v);
    finite_cnt += fin ? 1 : 0;
    win[i] = fin ? v : CUDART_INF_F;
  }
  for (int off = 16; off > 0; off >>= 1)
    finite_cnt += __shfl_xor_sync(0xffffffffu, finite_cnt, off);
  __syncwarp();

  // the same float32 arithmetic as the twin: rank = q * (cnt - 1)
  const float cntf = (float)finite_cnt;
  const float rankf = __fmul_rn(q, __fsub_rn(cntf, 1.0f));
  int lo = (int)floorf(rankf);
  lo = lo < 0 ? 0 : (lo > L - 1 ? L - 1 : lo);
  int hi = lo + 1 > L - 1 ? L - 1 : lo + 1;
  const int last = finite_cnt - 1 > 0 ? finite_cnt - 1 : 0;
  hi = hi < last ? hi : last;

  // rank of element i = #elements ordered before it (value, then index);
  // ranks form a permutation, so exactly one lane owns each of lo and hi
  for (int i = lane; i < L; i += 32) {
    const float vi = win[i];
    int rank = 0;
    for (int j = 0; j < L; ++j) {
      const float vj = win[j];
      rank += (vj < vi) || (vj == vi && j < i);
    }
    if (rank == lo) sel[0] = vi;
    if (rank == hi) sel[1] = vi;
  }
  __syncwarp();

  if (lane == 0) {
    const float v_lo = sel[0];
    const float v_hi = sel[1];
    const float frac = __fsub_rn(rankf, (float)lo);
    float r = __fadd_rn(v_lo, __fmul_rn(__fsub_rn(v_hi, v_lo), frac));
    if (finite_cnt < mp) r = CUDART_NAN_F;
    out[(long long)s * K + k] = r;
  }
}

}  // namespace

// C interface for ctypes. Returns cudaGetLastError() after the launch
// (0 = launched); the caller allocates ``out`` (S, K) and validates shapes.
extern "C" int qtail_launch(const float* x, float* out, int S, int W, int L,
                            int K, float q, int mp, void* stream) {
  if (S <= 0 || K <= 0) return 0;
  const long long tasks = (long long)S * K;
  const int blocks = (int)((tasks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = (size_t)kWarpsPerBlock * (L + 2) * sizeof(float);
  qtail_kernel<<<blocks, kWarpsPerBlock * 32, smem, (cudaStream_t)stream>>>(
      x, out, S, W, L, K, q, mp);
  return (int)cudaGetLastError();
}

extern "C" int qtail_max_window() {
  // dynamic shared memory stays under the 48 KB default without opt-in
  return (48 * 1024) / (kWarpsPerBlock * (int)sizeof(float)) - 2;
}
