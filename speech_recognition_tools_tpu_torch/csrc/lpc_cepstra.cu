// Autocorrelation lags -> LPC (Levinson-Durbin) -> cepstra, one warp per row.
//
// Replaces the Pallas TPU kernel
// speech_recognition_tools_tpu/ops/pallas_lpc.py::_lpc_cepstra_kernel and
// computes the function of lpc_cepstra_reference() in ops/lpc_cepstra.py:
//
//   rn      = r[1..p] / r0                      (r0 == 0 -> divide by 1)
//   Levinson-Durbin to order p on rn, with |k| <= 1 - 16 eps(f32) and the
//   prediction error floored at FLT_MIN before each division
//   gg      = r0 + r1 + sum_k a_k r_{k+1}        (reference gain quirk)
//   gg <= 0 -> max(max(E_p r0, 0), 1.1754944e-38);  unity_gain -> gg = 1
//   c_0     = log(sqrt(gg)),  c_1 = -a_1,
//   c_n     = sum_{m=1}^{n-1} (m/n) b[n-m] c_m + b[n],  b = [1, -a, 0, ...]
//
// The TPU kernel floors the Levinson error at 1e-37 while the XLA scans
// (ops/levinson.py) floor it at finfo(f32).tiny; kernel and plain version
// here both use FLT_MIN, so they compute one function. The floor only
// matters on degenerate rows whose error falls below 1e-37.
//
// What bounds it on an H100: a row reads p+2 floats and writes lim, and
// needs ~2p^2 + lim^2 flops (a dot and an update per Levinson step; one FMA
// per cepstrum term, keeping m c_m) through two strictly sequential
// recursions (p steps, then lim-2 steps), each step a reduction whose
// result the next step needs. At the e2e shape (23,040 rows, p=150,
// lim=100) that is ~1.27 GFLOP (~19 us at 67 TFLOP/s f32) against ~23 MB
// (~7 us at 3.35 TB/s): operations bind. At the hybrid shape (10,240 rows,
// p=50, lim=50) it is ~77 MFLOP (~1.15 us) against ~4.2 MB (~1.25 us):
// bytes bind, narrowly.
//
// Design: one warp per row, so each step's dot product is a strided
// per-lane partial sum and one __shfl_xor_sync butterfly, with no block-wide
// barrier. The lags, the predictor and its previous copy (ping-pong, so a
// step reads the old predictor while writing the new one) and the cepstra
// live in shared memory. Several rows per block; the ragged last block is
// masked by returning whole warps. Rows are written in natural order (the
// TPU kernel wrote them reversed for its shift registers). With vectors of
// at most p entries, a step gives each lane only a few FMAs against a
// five-level shuffle and its bookkeeping, so the kernel is bound by issued
// instructions per step; fewer lanes per row is the next design to try.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 4;          // warps (one row each) per block
constexpr int kMaxSmemPerBlock = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  // every lane holds the same tree of sums; broadcast lane 0's anyway so
  // the recursion's scalars are identical across the warp by construction
  return __shfl_sync(kFull, v, 0);
}

__global__ void lpc_cepstra_kernel(const float* __restrict__ r, float* __restrict__ out,
                                   int rows, int ld, int p, int lim, int unity_gain) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= rows) return;  // whole warps leave; no block barrier follows

  const int per_row = 3 * p + lim;
  float* rn = smem + warp * per_row;  // normalised lags rn[j] = r[j+1]/r0
  float* a_cur = rn + p;              // predictor a[j] = a_{j+1}
  float* a_nxt = a_cur + p;
  float* cep = a_nxt + p;

  const float* rr = r + static_cast<long long>(row) * ld;
  const float r0 = rr[0];
  const float safe_r0 = (r0 == 0.f) ? 1.f : r0;
  for (int j = lane; j < p; j += kWarp) rn[j] = rr[j + 1] / safe_r0;
  __syncwarp();

  // ---- Levinson-Durbin ----
  const float kmax = 1.f - 16.f * FLT_EPSILON;
  float e = 1.f;
  for (int s = 0; s < p; ++s) {
    float part = 0.f;
    for (int j = lane; j < s; j += kWarp) part += a_cur[j] * rn[s - 1 - j];
    const float acc = warp_sum(part);
    const float e_safe = (e < FLT_MIN) ? FLT_MIN : e;
    float k = -(rn[s] + acc) / e_safe;
    k = fminf(fmaxf(k, -kmax), kmax);
    for (int j = lane; j < s; j += kWarp) a_nxt[j] = a_cur[j] + k * a_cur[s - 1 - j];
    if (lane == 0) a_nxt[s] = k;
    e = e * (1.f - k * k);
    __syncwarp();
    float* t = a_cur;
    a_cur = a_nxt;
    a_nxt = t;
  }
  const float* a = a_cur;

  // ---- gain (reference quirk) with the negative-gain fallback ----
  float gpart = 0.f;
  for (int j = lane; j < p; j += kWarp) gpart += a[j] * rr[j + 2];
  float gg = r0 + (rr[1] + warp_sum(gpart));
  if (!(gg > 0.f)) gg = fmaxf(fmaxf(e * r0, 0.f), 1.1754944e-38f);
  if (unity_gain) gg = 1.f;

  // ---- cepstrum recursion ----
  float* o = out + static_cast<long long>(row) * lim;
  if (lane == 0) {
    cep[0] = logf(sqrtf(gg));
    if (lim > 1) cep[1] = (p >= 1) ? -a[0] : 0.f;
  }
  __syncwarp();
  for (int n = 2; n < lim; ++n) {
    const float inv_n = 1.f / static_cast<float>(n);
    float part = 0.f;
    for (int m = 1 + lane; m < n; m += kWarp) {
      const int q = n - m;  // 1 <= q <= n-1
      const float bq = (q <= p) ? -a[q - 1] : 0.f;
      part += (static_cast<float>(m) * inv_n) * bq * cep[m];
    }
    const float acc = warp_sum(part);
    if (lane == 0) cep[n] = acc + ((n <= p) ? -a[n - 1] : 0.f);
    __syncwarp();
  }
  for (int j = lane; j < lim; j += kWarp) o[j] = cep[j];
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// r: (rows, ld) f32 row-major with ld >= order + 2; out: (rows, lim) f32.
int lpc_cepstra_f32(const float* r, float* out, int rows, int ld, int order, int lim,
                    int unity_gain, void* stream) {
  if (rows <= 0) return 0;
  const int per_row = (3 * order + lim) * static_cast<int>(sizeof(float));
  if (per_row > kMaxSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = kMaxSmemPerBlock / per_row;
  const int rows_per_block = fit < kRowsPerBlock ? fit : kRowsPerBlock;
  const int smem = rows_per_block * per_row;
  cudaError_t err = cudaFuncSetAttribute(
      lpc_cepstra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  lpc_cepstra_kernel<<<blocks, rows_per_block * kWarp, smem,
                       static_cast<cudaStream_t>(stream)>>>(r, out, rows, ld, order, lim,
                                                            unity_gain);
  return static_cast<int>(cudaGetLastError());
}

const char* lpc_cepstra_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
