// Autocorrelation lags -> LPC (Levinson-Durbin) -> cepstra: a group of L
// lanes per row, the recursion state in registers.
//
// Replaces the Pallas TPU kernel
// speech_recognition_tools_tpu/ops/pallas_lpc.py::_lpc_cepstra_kernel and
// computes the function of lpc_cepstra_reference() in ops/lpc_cepstra.py:
//
//   rn      = r[1..p] / r0                      (r0 == 0 -> divide by 1)
//   Levinson-Durbin to order p on rn, with |k| <= 1 - 16 eps(f32) and the
//   prediction error floored at FLT_MIN before each division
//   gg      = r0 + r1 + sum_k a_k r_{k+1}        (reference gain quirk)
//   gg <= 0 -> max(max(E_p r0, 0), FLT_MIN);  unity_gain -> gg = 1
//   c_0     = log(sqrt(gg)),  c_1 = -a_1,
//   c_n     = sum_{m=1}^{n-1} (m/n) b[n-m] c_m + b[n],  b = [1, -a, 0, ...]
//
// The TPU kernel floors the Levinson error at 1e-37 while the XLA scans
// (ops/levinson.py) floor it at finfo(f32).tiny; kernel and plain version
// here both use FLT_MIN, so they compute one function.
//
// What bounds it on an H100: a row reads p+2 floats and writes lim, and
// needs ~2p^2 + 2 lim min(p, lim) flops through two strictly sequential
// recursions (p steps, then lim-2 steps), each step a reduction whose
// result the next step needs. At (23040 rows, p 150, lim 100) and at
// (23040, 150, 450) operations bind (~19 us and ~55 us at 67 TFLOP/s f32,
// against ~23 MB and ~56 MB of bytes); at (10240, 50, 50) bytes bind,
// narrowly (~1.25 us). In practice every step's dependent chain (a dot,
// a shuffle reduction, a division) and the instructions issued per step
// bound it, far above either.
//
// Design.
// - A group of L lanes (L in {1, 2, 4, 8, 16}, a template parameter) per
//   row; a warp holds 32/L rows. A step's reduction is log2(L)
//   __shfl_xor_sync calls of width L and leaves the same sum, bit for bit,
//   on every lane of the group, so no broadcast follows.
// - Lane g of a group holds the contiguous chunk [g C, g C + C) of each
//   vector in registers (C a template parameter, so every register index
//   is a compile-time constant). Levinson runs in the TPU kernel's
//   shift-register form (pallas_lpc.py:53-69), which has no reversed index:
//       a' = a + k u,   u' = [k, (u + k a)[:-1]] (u seeded with a_0 = 1),
//       s' = [r_i, s[:-1]],   acc = sum a s.
//   A shift by one is a rotation of the register chunk plus one
//   __shfl_up_sync from the neighbouring lane. The rotation costs nothing:
//   the step loop is unrolled C times, and in step c of a round the
//   logical entry j of a chunk lives in register (j - c) mod C, so only the
//   entry that leaves a lane's chunk is replaced (by the one arriving from
//   the lane before). Entries past p stay zero for all p steps, so the last
//   chunk's tail needs no mask.
// - The cepstrum keeps d_m = m c_m in a window of the p latest values,
//   W[j] = d_{n-1-j}, with the same rotation: only b[q] for q <= p is
//   nonzero, so c_n = b[n] - (sum_j a_{j+1} W[j]) / n is one FMA a term
//   over min(p, n-1) live terms, whatever lim is.
// - Lags are staged block-wide into shared memory (consecutive threads on
//   consecutive addresses), normalised there once, and read back one lag a
//   step, which every lane of a group reads at the same address. The
//   cepstra are staged in the same row buffer and written block-wide.
// - No tensor cores, TMA or wgmma: every row solves its own Toeplitz
//   system, so no operand is shared across rows that a matrix unit could
//   take, and the whole input is at most ~23 MB (~7 us at 3.35 TB/s), so
//   an asynchronous bulk copy would buy nothing measurable.
// - The host picks (L, C, rows per block) from (order, lim) with a plain
//   Python function (ops/lpc_cepstra.py::launch_plan) among the
//   instantiations listed below. Each lane count is compiled by its own
//   nvcc process with -DK1_LANES=L; the translation unit without it holds
//   the C entry point.

#include <cuda_runtime.h>
#include <float.h>

// The instantiations: every (lanes, chunk) pair of these two lists.
#define K1_LANE_LIST(X) X(1) X(2) X(4) X(8) X(16)
#define K1_CHUNK_LIST(X) X(4) X(8) X(12) X(16) X(20) X(28) X(40)

#define K1_CAT_(a, b) a##b
#define K1_CAT(a, b) K1_CAT_(a, b)

namespace {
constexpr int kMaxSmemPerBlock = 232448;  // bytes a block may use on sm_90
}  // namespace

// One launcher per lane count, defined in that lane count's unit.
#define K1_DECLARE_LAUNCHER(L)                                                          \
  extern "C" int K1_CAT(lpc_cepstra_lanes_, L)(const float* r, float* out, int rows,   \
                                               int ld, int p, int lim, int unity_gain, \
                                               int chunk, int rows_per_block, int stride, \
                                               cudaStream_t stream);
K1_LANE_LIST(K1_DECLARE_LAUNCHER)

#ifdef K1_LANES

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off, L);
  return v;
}

// blockDim.x = rows_per_block * L (a multiple of 32); `stride` floats of
// shared memory per row: the raw lags at [0, p+2), the normalised ones at
// [p+2, 2p+2), and later the row's cepstra at [0, lim).
template <int L, int C>
__global__ void lpc_cepstra_kernel(const float* __restrict__ r, float* __restrict__ out,
                                   int rows, int ld, int p, int lim, int stride,
                                   int unity_gain) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int R = blockDim.x / L;
  const int g = tid % L;  // lane within the row's group
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int w = p + 2;

  // Stage the block's lags. Rows past the end read as zeros (they solve a
  // harmless system and are not written back), so every thread stays live
  // for the shuffles and barriers below.
  for (int i = tid; i < R * w; i += blockDim.x) {
    const int lr = i / w;
    const int col = i - lr * w;
    const long long grow = row0 + lr;
    smem[lr * stride + col] = grow < rows ? r[grow * ld + col] : 0.f;
  }
  __syncthreads();
  float* buf = smem + (tid / L) * stride;
  float* rn = buf + w;
  const float r0 = buf[0];
  const float safe_r0 = (r0 == 0.f) ? 1.f : r0;
  for (int j = g; j < p; j += L) rn[j] = buf[j + 1] / safe_r0;
  __syncwarp();

  // ---- Levinson-Durbin, shift-register form ----
  float a[C], u[C], s[C];
#pragma unroll
  for (int j = 0; j < C; ++j) a[j] = u[j] = s[j] = 0.f;
  if (g == 0) u[0] = 1.f;
  const float kmax = 1.f - 16.f * FLT_EPSILON;
  float e = 1.f;
  for (int base = 0; base < p; base += C) {
#pragma unroll
    for (int c = 0; c < C; ++c) {  // rotation offset c: entry j in register (j-c) mod C
      if (base + c < p) {
        const float r_i = rn[base + c];
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < C; ++j) part = fmaf(a[j], s[(j - c + C) % C], part);
        const float acc = group_sum<L>(part);
        const float e_safe = (e < FLT_MIN) ? FLT_MIN : e;
        float k = -(r_i + acc) / e_safe;
        k = fminf(fmaxf(k, -kmax), kmax);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int q = (j - c + C) % C;
          const float aj = a[j];
          const float uq = u[q];
          a[j] = fmaf(k, uq, aj);
          u[q] = fmaf(k, aj, uq);
        }
        // the chunk's last entry leaves for the next lane; the previous
        // lane's arrives in its register (lane 0 takes k and r_i)
        const int last = C - 1 - c;
        const float u_in = __shfl_up_sync(kFull, u[last], 1, L);
        const float s_in = __shfl_up_sync(kFull, s[last], 1, L);
        u[last] = (g == 0) ? k : u_in;
        s[last] = (g == 0) ? r_i : s_in;
        e = e * (1.f - k * k);
      }
    }
  }

  // ---- gain (reference quirk) with the negative-gain fallback ----
  float gpart = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int jj = g * C + j;
    if (jj < p) gpart = fmaf(a[j], buf[jj + 2], gpart);
  }
  float gg = r0 + (buf[1] + group_sum<L>(gpart));
  if (!(gg > 0.f)) gg = fmaxf(fmaxf(e * r0, 0.f), FLT_MIN);
  if (unity_gain) gg = 1.f;
  __syncwarp();  // the row's lags are read; its cepstra take their place

  // ---- cepstrum recursion over a window of d_m = m c_m ----
  if (g == 0) buf[0] = logf(sqrtf(gg));
  if (lim > 1) {
    float d[C];  // logical entry j holds d_{n-1-j}
#pragma unroll
    for (int j = 0; j < C; ++j) d[j] = 0.f;
    const float c1 = -__shfl_sync(kFull, a[0], 0, L);
    if (g == 0) {
      buf[1] = c1;
      d[0] = c1;
    }
    const int steps = lim - 2;
    for (int base = 0; base < steps; base += C) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (base + c < steps) {
          const int n = base + c + 2;
          // b[n] = -a_n = -a[n-1], in lane (n-1)/C, register (c+1) mod C
          const int q = n - 1;
          const float a_q = __shfl_sync(kFull, a[(c + 1) % C], (q / C) & (L - 1), L);
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < C; ++j) part = fmaf(a[j], d[(j - c + C) % C], part);
          const float sum = group_sum<L>(part);
          const float cn = ((q < p) ? -a_q : 0.f) - sum / static_cast<float>(n);
          if (g == 0) buf[n] = cn;
          const int last = C - 1 - c;
          const float d_in = __shfl_up_sync(kFull, d[last], 1, L);
          d[last] = (g == 0) ? static_cast<float>(n) * cn : d_in;
        }
      }
    }
  }
  __syncthreads();

  // Write the block's rows, which are contiguous in `out`.
  const long long left = rows - row0;
  const int nrows = left < R ? static_cast<int>(left) : R;
  for (int i = tid; i < nrows * lim; i += blockDim.x) {
    const int lr = i / lim;
    const int col = i - lr * lim;
    out[(row0 + lr) * lim + col] = smem[lr * stride + col];
  }
}

template <int L, int C>
int launch(const float* r, float* out, int rows, int ld, int p, int lim, int unity_gain,
           int rows_per_block, int stride, cudaStream_t stream) {
  // Allow the largest dynamic shared memory once per device, not per launch.
  static unsigned long long attribute_set = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !((attribute_set >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(lpc_cepstra_kernel<L, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemPerBlock);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) attribute_set |= 1ull << dev;
  }
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = static_cast<size_t>(rows_per_block) * stride * sizeof(float);
  lpc_cepstra_kernel<L, C><<<blocks, rows_per_block * L, smem, stream>>>(
      r, out, rows, ld, p, lim, stride, unity_gain);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define K1_CHUNK_CASE(C) \
  case C:                \
    return launch<K1_LANES, C>(r, out, rows, ld, p, lim, unity_gain, rows_per_block, stride, stream);

extern "C" int K1_CAT(lpc_cepstra_lanes_, K1_LANES)(const float* r, float* out, int rows,
                                                     int ld, int p, int lim, int unity_gain,
                                                     int chunk, int rows_per_block, int stride,
                                                     cudaStream_t stream) {
  switch (chunk) {
    K1_CHUNK_LIST(K1_CHUNK_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

#else  // the C entry point

extern "C" {

// Launch on `stream` with `lanes` lanes per row, register chunks of
// `chunk` entries and `rows_per_block` rows per block; returns the
// cudaError_t of the launch (0 on success). r: (rows, ld) f32 row-major
// with ld >= order + 2; out: (rows, lim) f32. A (lanes, chunk) pair that is
// not instantiated, lanes * chunk < order, a block that is not whole warps
// or a row buffer that does not fit returns cudaErrorInvalidValue.
int lpc_cepstra_f32(const float* r, float* out, int rows, int ld, int order, int lim,
                    int unity_gain, int lanes, int chunk, int rows_per_block,
                    void* stream) {
  if (rows <= 0) return 0;
  const int threads = rows_per_block * lanes;
  if (order < 1 || lim < 1 || ld < order + 2 || rows_per_block < 1 || lanes < 1 ||
      chunk < 1 || lanes * chunk < order || threads % 32 != 0 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int stride = 2 * order + 2 > lim ? 2 * order + 2 : lim;
  stride |= 1;  // odd, so the groups of a warp read different banks
  if (static_cast<long long>(rows_per_block) * stride * 4 > kMaxSmemPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K1_LANE_CASE(L)                                                                 \
  case L:                                                                               \
    return K1_CAT(lpc_cepstra_lanes_, L)(r, out, rows, ld, order, lim, unity_gain, chunk, \
                                         rows_per_block, stride, st);
  switch (lanes) {
    K1_LANE_LIST(K1_LANE_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K1_LANE_CASE
}

const char* lpc_cepstra_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // K1_LANES
