// The time loop of one masked GRU layer (kernel K3): one launch carries the
// recurrence over all T frames forward, one launch carries its gradient
// back over them.
//
// Computes the function of ops/gru_scan.py::gru_scan_reference, given the
// input projection xi = W_i x + b_i (B, T, 3H) gate-stacked (r|z|n):
//
//   r  = sigmoid(xi_r + W_hr h)        z = sigmoid(xi_z + W_hz h)
//   n  = tanh(xi_n + r * (W_hn h + b_hn))
//   h' = (1 - z) * n + z * h
//
// with h = 0 before frame 0, the carry frozen and the output 0 on frames
// t >= lengths[b]. The forward stores, when a gradient is wanted, r, z, n
// and W_hn h + b_hn of every valid frame (B, T, 4H); the previous carry
// is the previous frame's output. The backward walks t = T-1 .. 0:
//
//   g   = dy_t + dh_t                      (dh_t: the carry's gradient)
//   dn  = g (1 - z) (1 - n^2)              dz = g (h_{t-1} - n) z (1 - z)
//   dhn = dn r                             dr = dn (W_hn h + b_hn) r (1 - r)
//   dxi = (dr, dz, dn)                     dhh = (dr, dz, dhn)
//   dh_{t-1} = g z + W_hh^T dhh
//
// and passes dh_t to dh_{t-1} unchanged on frames past the length. It
// writes dxi and dhh (B, T, 3H); the wrapper forms dW_hh = dhh^T h_{t-1}
// and d b_hn = sum dhh_n as plain matrix products.
//
// It replaces no Pallas kernel. The JAX package runs this recurrence as a
// lax.scan (speech_recognition_tools_tpu/models/recurrent.py), which XLA
// compiles into one loop on the TPU; the port's plain version steps the
// frames in Python, ~15 launches a frame forward and ~30 in autograd, and
// those launches bound the hybrid training step.
//
// What bounds it on an H100: a frame's recurrent product is 2 B 3H H
// operations in float32 (TF32 is off, so no tensor cores), 50 MFLOP at B
// 32, H 512: 0.75 us at 67 TFLOP/s, 0.46 ms over 608 frames; its bytes (xi
// in, y and the gates out) take a third of that at 3.35 TB/s. So
// operations bound it, and in practice the dependence of every frame on
// the last: a frame cannot start before every unit of the previous one is
// known, so its latency (product, gate algebra, exchange) is the time.
// The product itself is bound by shared-memory reads and their latency
// more than by its FMAs (measured: ~2x its FMA issue time at H 512).
//
// Design.
// - A thread block cluster takes BG batch rows (a template parameter) and
//   splits the hidden units among its cs blocks (up to 16, non-portable):
//   block c owns U = ceil(H / cs) units and all three gate rows of each,
//   so a unit's gate algebra is local. Clusters never wait on each other.
// - The block's slice of W_hh (3U x H) stays in shared memory for the
//   whole launch where it fits (H <= 512: 192 KB at H 512, cs 16);
//   otherwise (H <= 1024) the same code reads it from L2 every frame (the
//   SMEM template parameter). The host lays the slice out for the reads
//   the kernel makes (ops/gru_scan.py::_slices).
// - Forward, a frame: each of the 8 warps (two a scheduler, so that one
//   hides the other's latency) takes an eighth of the H inputs. A lane
//   takes 4 units (12 gate rows) over every fourth of them, so 3 16-byte
//   conflict-free reads of W and BG / 2 reads of h (one value for 8
//   lanes) feed 12 BG FMAs, the next input's reads in flight; two shuffle
//   rounds leave each lane one unit's 3 rows. Warps w and w + 4 merge
//   their partial sums, the 4 merged ones meet in shared memory, and warp
//   w finishes row w. The new h of the block's units goes to every block
//   of the cluster through distributed shared memory (double-buffered) by
//   st.async in 16-byte pieces whose peer addresses are mapped once, each
//   byte counted on the receiving block's mbarrier: a block waits for its
//   peers' bytes alone. No cluster-wide barrier a frame (its release
//   would also wait for the frame's global stores of y and the gates), no
//   grid-wide barrier.
// - Backward, a frame: the gate side as above gives dhh of the block's own
//   3U rows; the block forms its share W_own^T dhh for all H units (a lane
//   8 units over every fourth row, 2 16-byte reads of W feeding 8 BG FMAs,
//   two shuffle rounds) and sends each block the share of that block's
//   units (a reduce-scatter through distributed shared memory,
//   double-buffered, counted on the owner's mbarrier); each block sums the
//   cs shares of its units. The weight slice is the forward's, so it fits
//   where the forward's does; splitting W_hh by input unit instead would
//   exchange 3H values a row, whose double buffer does not fit beside the
//   slice.
// - The host lays out the weight slices (cs blocks of U = ceil(H / cs)
//   units, UPT units a lane) and picks the variant from H alone
//   (ops/gru_scan.py::launch_plan): H <= 512 one unit a lane with the
//   slice in shared memory, 512 < H <= 1024 two units a lane reading it
//   from L2. K3_CONFIG_LIST holds one instantiation a UPT, with its BG
//   and SMEM; the instantiation's launch computes its shared memory from
//   the layout the kernel carves (smem_bytes, beside the kernels) and the
//   clusters from B. More clusters than the card holds at once is fine:
//   clusters never wait on each other. Each instantiation is compiled by
//   its own nvcc process with -DK3_UPT, -DK3_BG, -DK3_SMEM; the
//   translation unit without them holds the C entry points.
// - Accurate expf and tanhf, no fast-math intrinsics; float32 throughout.
//   A wait that never ends traps (a launch fault), so a fault in the
//   exchange cannot hang the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The instantiations (UPT, BG, SMEM), one a UPT: units a lane carries,
// batch rows a cluster carries, whether the weight slice sits in shared
// memory. At H 512 BG 6 is the most rows whose h double buffer and partial
// sums fit beside the slice (230,400 of 232,448 bytes).
#define K3_CONFIG_LIST(X) X(1, 6, 1) X(2, 8, 0)

#define K3_NAME_(kind, u, b, s) gru_scan_##kind##_u##u##_b##b##_s##s
#define K3_NAME(kind, u, b, s) K3_NAME_(kind, u, b, s)

// A launch's arguments (at namespace scope: the C entry points of every
// unit take them).
struct FwdArgs {
  const float* xi;           // (B, T, 3H)
  const float* w;            // (cs, H, 96 UPT): block c's rows, k-major
  const float* bias_hn;      // (H,)
  const int64_t* lengths;    // (B,)
  float* y;                  // (B, T, H)
  float* gates;              // (B, T, 4H) r|z|n|W_hn h + b_hn, or null
  int B, T, H, cs, U;
};

struct BwdArgs {
  const float* dy;           // (B, T, H)
  const float* y;            // (B, T, H): the forward's output
  const float* gates;        // (B, T, 4H)
  const float* w;            // (cs, 96 UPT, H): block c's rows, row-major
  const int64_t* lengths;    // (B,)
  float* dxi;                // (B, T, 3H)
  float* dhh;                // (B, T, 3H)
  int B, T, H, cs, U;
};

#define K3_DECLARE(U, B, S)                                                 \
  extern "C" int K3_NAME(fwd, U, B, S)(const FwdArgs* a, cudaStream_t stream); \
  extern "C" int K3_NAME(bwd, U, B, S)(const BwdArgs* a, cudaStream_t stream);
K3_CONFIG_LIST(K3_DECLARE)

#ifdef K3_UPT

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;  // two a scheduler, so one hides the other's latency
constexpr int kThreads = 32 * kWarps;
constexpr int kRedSlots = 4;  // the forward's partial sums, warps w and w + 4 merged
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use on sm_90
constexpr int kGroup = 2;     // inputs or rows a group of the one-unit-a-lane products

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// BG consecutive floats (8-byte aligned; 16 where BG % 4 == 0).
template <int BG>
__device__ __forceinline__ void load_rows(float (&v)[BG], const float* p) {
  if constexpr (BG % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BG / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < BG / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(p)[q];
      v[2 * q] = x.x;
      v[2 * q + 1] = x.y;
    }
  }
}

// kG inputs' h (BG rows each) and W (UPT units x 3 gates each) of a lane.
template <int UPT, int BG, int kG>
struct FwdGroup {
  float h[kG][BG];
  float w[kG][UPT][3];
};

// kG rows' dhh (BG rows each) and W (a lane's kKPT units each).
template <int BG, int kKPT, int kG>
struct BwdGroup {
  float d[kG][BG];
  float w[kG][kKPT];
};

__device__ __forceinline__ int clamp_len(int64_t len, int T) {
  return len <= 0 ? 0 : (len >= T ? T : static_cast<int>(len));
}

// Distributed shared memory with completion counted in bytes on the
// receiving block's mbarrier (PTX st.async, sm_90): a block waits on its
// own barrier for the bytes its peers send it, with no cluster-wide
// barrier, so no frame waits for the global stores before it (a
// barrier.cluster.arrive releases every earlier write, these included).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `addr` (this block's) in block `rank`.
__device__ __forceinline__ uint32_t peer(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void send2(uint32_t addr, float v0, float v1, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
               ::"r"(addr), "f"(v0), "f"(v1), "r"(bar) : "memory");
}

__device__ __forceinline__ void send4(uint32_t addr, float v0, float v1, float v2, float v3,
                                      uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "f"(v0), "f"(v1), "f"(v2), "f"(v3), "r"(bar) : "memory");
}

// BG consecutive floats to a peer block (8-byte aligned; 16 where BG % 4 == 0).
template <int BG>
__device__ __forceinline__ void send_rows(uint32_t addr, const float (&v)[BG], uint32_t bar) {
  if constexpr (BG % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BG / 4; ++q)
      send4(addr + 16 * q, v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3], bar);
  } else {
#pragma unroll
    for (int q = 0; q < BG / 2; ++q) send2(addr + 8 * q, v[2 * q], v[2 * q + 1], bar);
  }
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// One thread: this phase's arrival, expecting `bytes` from the peers.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Every thread: wait for the phase of parity `parity` to complete. A wait
// that does not end within ~2^26 polls traps: a fault to report, not a
// hang of the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// Grid (cs, clusters), cluster (cs, 1, 1). Shared memory, in floats: the
// weight slice [H][96 UPT] (SMEM only), h [2][H][BG] (double-buffered,
// row b of unit k at k BG + b), the warps' partial sums
// [kRedSlots][UPT][3][BG][32]; and the two buffers' mbarriers.
//
// h_{t+1} goes into buffer (t+1) & 1 of every block. A block overwrites a
// peer's buffer only after receiving the peer's h_t, which the peer sends
// after its every warp has read that buffer (frame t-1), so two buffers
// and the data's own dependences suffice.
template <int UPT, int BG, bool SMEM>
__global__ void __launch_bounds__(kThreads, 1) gru_fwd_kernel(FwdArgs a) {
  constexpr int kRow = 96 * UPT;                   // weight floats of one input unit
  constexpr int kRW = (BG + kWarps - 1) / kWarps;  // rows of a warp's gate side
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int B = a.B, T = a.T, H = a.H, cs = a.cs;
  const int b0 = blockIdx.y * BG;
  const int u0 = rank * a.U;
  const int nu = max(0, min(a.U, H - u0));  // the block's units

  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const hbuf = smem + (SMEM ? H * kRow : 0);
  float* const red = hbuf + 2 * H * BG;
  __shared__ uint64_t full[2];  // h_t complete in buffer t & 1
  if (threadIdx.x == 0) {
    bar_init(smem_u32(&full[0]));
    bar_init(smem_u32(&full[1]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const uint32_t expect = static_cast<uint32_t>((H - nu) * BG * 4);  // bytes of h a frame
  uint32_t phases = 0;  // bit p: the parity of buffer p's next phase
  const float* const wsrc = a.w + static_cast<size_t>(rank) * H * kRow;
  if constexpr (SMEM) {
    const float4* s = reinterpret_cast<const float4*>(wsrc);
    float4* d = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < H * kRow / 4; i += kThreads) d[i] = __ldg(s + i);
  }
  for (int i = threadIdx.x; i < 2 * H * BG; i += kThreads) hbuf[i] = 0.f;
  const float* const w = SMEM ? smem : wsrc;

  // The gate side: warp w takes the block's rows w, w + kWarps, ...; lane
  // l the units l + 32 i.
  int len[kRW];
  bool live[kRW][UPT];
  float bhn[UPT];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const int bg = b0 + warp + kWarps * r;
    len[r] = (warp + kWarps * r < BG && bg < B) ? clamp_len(a.lengths[bg], T) : 0;
#pragma unroll
    for (int i = 0; i < UPT; ++i) live[r][i] = lane + 32 * i < nu && len[r] > 0;
  }
#pragma unroll
  for (int i = 0; i < UPT; ++i) bhn[i] = lane + 32 * i < nu ? a.bias_hn[u0 + lane + 32 * i] : 0.f;

  // xi of the gate side's valid frames, loaded a frame ahead
  float xc[kRW][UPT][3], xn[kRW][UPT][3];
  auto load_xi = [&](float (&x)[kRW][UPT][3], int t) {
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        const bool valid = live[r][i] && t < len[r];
        const float* p = a.xi + (static_cast<size_t>(b0 + warp + kWarps * r) * T + t) * 3 * H +
                         u0 + lane + 32 * i;
#pragma unroll
        for (int g = 0; g < 3; ++g) x[r][i][g] = valid ? __ldg(p + g * H) : 0.f;
      }
    }
  };
  load_xi(xc, 0);

  const int kc = (H + 4 * kWarps - 1) / (4 * kWarps) * 4;  // a warp's inputs, a multiple of 4
  const int kb = min(H, warp * kc), ke = min(H, kb + kc);
  cluster.sync();  // every block of the cluster has started, zeroed h, set its barriers

  // This thread's 16-byte pieces of the exchange, mapped once: piece e <
  // (cs - 1) n4 is float4 e % n4 of the block's own units to peer e / n4
  // (skipping this block), into h buffer 0 or 1 and its barrier.
  constexpr int kSends = (8 * BG * 15 + kThreads - 1) / kThreads;  // n4 <= 8 BG, cs <= 16
  const bool aligned = UPT == 1 && (u0 * BG) % 4 == 0 && (nu * BG) % 4 == 0;
  uint32_t sa0[kSends], sa1[kSends], sb0[kSends], sb1[kSends];
  int so[kSends], nsend = 0;
#pragma unroll
  for (int q = 0; q < kSends; ++q) {
    const int n4 = max(1, nu * BG / 4), e = threadIdx.x + q * kThreads;
    const int d = e / n4, off = e - d * n4, dst = d < rank ? d : d + 1;
    const bool live_piece = aligned && nu > 0 && e < n4 * (cs - 1);
    so[q] = off;
    sa0[q] = live_piece ? peer(smem_u32(hbuf + u0 * BG + 4 * off), dst) : 0u;
    sa1[q] = live_piece ? peer(smem_u32(hbuf + H * BG + u0 * BG + 4 * off), dst) : 0u;
    sb0[q] = live_piece ? peer(smem_u32(&full[0]), dst) : 0u;
    sb1[q] = live_piece ? peer(smem_u32(&full[1]), dst) : 0u;
    if (live_piece) nsend = q + 1;
  }

  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    const float* const hc = hbuf + p * H * BG;
    float* const hn = hbuf + (p ^ 1) * H * BG;
    if (t > 0) {  // h_t: the peers' units by st.async, this block's own by its warps
      if (threadIdx.x == 0) bar_expect(smem_u32(&full[p]), expect);
      bar_wait(smem_u32(&full[p]), (phases >> p) & 1);
      phases ^= 1u << p;
      __syncthreads();
    }
    if (t + 1 < T) load_xi(xn, t + 1);

    // this warp's share of W_own h over its inputs
    if constexpr (UPT == 1) {
      // a lane takes 4 units (12 rows, a = lane & 7) over every fourth of
      // the warp's inputs (c = lane >> 3): 3 16-byte reads of W and BG / 2
      // reads of h (8 lanes a value) feed 12 BG FMAs
      const int a = lane & 7, c = lane >> 3;
      float acc[12][BG];
#pragma unroll
      for (int r = 0; r < 12; ++r)
#pragma unroll
        for (int b = 0; b < BG; ++b) acc[r][b] = 0.f;
      float wc[12], hv[BG], wn[12], hw[BG];
      auto load_k = [&](float (&wv)[12], float (&h)[BG], int k) {
        const float4* const wp = reinterpret_cast<const float4*>(w + static_cast<size_t>(k) * 96 + 12 * a);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float4 x = SMEM ? wp[q] : __ldg(wp + q);
          wv[4 * q] = x.x;
          wv[4 * q + 1] = x.y;
          wv[4 * q + 2] = x.z;
          wv[4 * q + 3] = x.w;
        }
        load_rows<BG>(h, hc + k * BG);
      };
      int k = kb + c;
      if (k < ke) load_k(wc, hv, k);
#pragma unroll 2
      for (; k < ke; k += 4) {
        load_k(wn, hw, k + 4 < ke ? k + 4 : k);  // the next input's loads in flight
#pragma unroll
        for (int r = 0; r < 12; ++r)
#pragma unroll
          for (int b = 0; b < BG; ++b) acc[r][b] = fmaf(wc[r], hv[b], acc[r][b]);
#pragma unroll
        for (int r = 0; r < 12; ++r) wc[r] = wn[r];
#pragma unroll
        for (int b = 0; b < BG; ++b) hv[b] = hw[b];
      }
      // the sum over the 4 lanes of a row block, halving the rows twice:
      // lane (a, c) ends with the 3 gate rows of unit 4 a + c
      const int hi = (c >> 1) & 1, lo = c & 1;
      float s6[6][BG], s3[3][BG];
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int b = 0; b < BG; ++b) {
          const float send = hi ? acc[r][b] : acc[6 + r][b];
          s6[r][b] = (hi ? acc[6 + r][b] : acc[r][b]) + __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int b = 0; b < BG; ++b) {
          const float send = lo ? s6[r][b] : s6[3 + r][b];
          s3[r][b] = (lo ? s6[3 + r][b] : s6[r][b]) + __shfl_xor_sync(0xffffffffu, send, 8);
        }
      const int slot = 4 * a + 2 * hi + lo;
      float* const part = red + (warp & 3) * 3 * BG * 32 + slot;
      if (warp >= kRedSlots) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int b = 0; b < BG; ++b) part[(g * BG + b) * 32] = s3[g][b];
      }
      __syncthreads();
      if (warp < kRedSlots) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int b = 0; b < BG; ++b) part[(g * BG + b) * 32] += s3[g][b];
      }
    } else {
      float acc[UPT][3][BG];
#pragma unroll
      for (int i = 0; i < UPT; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int b = 0; b < BG; ++b) acc[i][g][b] = 0.f;
      // in groups of kGroup inputs, the next group's loads in flight while
      // this group's FMAs run
      const float* const wl = w + 3 * lane;
      auto load_grp = [&](FwdGroup<UPT, BG, kGroup>& q, int k0) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          load_rows<BG>(q.h[u], hc + (k0 + u) * BG);
          const float* const wk = wl + static_cast<size_t>(k0 + u) * kRow;
#pragma unroll
          for (int i = 0; i < UPT; ++i)
#pragma unroll
            for (int g = 0; g < 3; ++g) q.w[u][i][g] = SMEM ? wk[96 * i + g] : __ldg(wk + 96 * i + g);
        }
      };
      auto fma_grp = [&](const FwdGroup<UPT, BG, kGroup>& q) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
#pragma unroll
          for (int i = 0; i < UPT; ++i)
#pragma unroll
            for (int g = 0; g < 3; ++g)
#pragma unroll
              for (int b = 0; b < BG; ++b) acc[i][g][b] = fmaf(q.w[u][i][g], q.h[u][b], acc[i][g][b]);
      };
      int k = kb;
      const int kfull = kb + (ke - kb) / kGroup * kGroup;
      if (k < kfull) {
        FwdGroup<UPT, BG, kGroup> cur, nxt;
        load_grp(cur, k);
        for (; k + kGroup < kfull; k += kGroup) {
          load_grp(nxt, k + kGroup);
          fma_grp(cur);
          cur = nxt;
        }
        fma_grp(cur);
        k += kGroup;
      }
      for (; k < ke; ++k) {  // the inputs past the last whole group
        FwdGroup<UPT, BG, 1> one;
        load_rows<BG>(one.h[0], hc + k * BG);
        const float* const wk = wl + static_cast<size_t>(k) * kRow;
#pragma unroll
        for (int i = 0; i < UPT; ++i)
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            const float wv = SMEM ? wk[96 * i + g] : __ldg(wk + 96 * i + g);
#pragma unroll
            for (int b = 0; b < BG; ++b) acc[i][g][b] = fmaf(wv, one.h[0][b], acc[i][g][b]);
          }
      }
      float* const part = red + (warp & 3) * UPT * 3 * BG * 32 + lane;
      if (warp >= kRedSlots) {
#pragma unroll
        for (int i = 0; i < UPT; ++i)
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int b = 0; b < BG; ++b) part[((i * 3 + g) * BG + b) * 32] = acc[i][g][b];
      }
      __syncthreads();
      if (warp < kRedSlots) {
#pragma unroll
        for (int i = 0; i < UPT; ++i)
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int b = 0; b < BG; ++b) part[((i * 3 + g) * BG + b) * 32] += acc[i][g][b];
      }
    }
    __syncthreads();

    // the gate side: the new h of the block's units; loads, algebra and
    // stores of a warp's rows each in one straight run, so that the
    // compiler interleaves the rows' dependent chains
    float s[kRW][UPT][3], hold[kRW][UPT];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int b = warp + kWarps * r;
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        const int slot = lane + 32 * i;
        s[r][i][0] = s[r][i][1] = s[r][i][2] = hold[r][i] = 0.f;
        if (b < BG && slot < nu && b0 + b < B) {
#pragma unroll
          for (int v = 0; v < kRedSlots; ++v)
#pragma unroll
            for (int g = 0; g < 3; ++g) s[r][i][g] += red[(((v * UPT + i) * 3 + g) * BG + b) * 32 + lane];
          hold[r][i] = hc[(u0 + slot) * BG + b];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int b = warp + kWarps * r;
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        const float rg = sigmoid(xc[r][i][0] + s[r][i][0]);
        const float zg = sigmoid(xc[r][i][1] + s[r][i][1]);
        const float hnb = s[r][i][2] + bhn[i];
        const float ng = tanhf(xc[r][i][2] + rg * hnb);
        const float hnew = (1.f - zg) * ng + zg * hold[r][i];
        const int slot = lane + 32 * i, u = u0 + slot;
        if (b < BG && slot < nu && b0 + b < B) {
          const size_t row = static_cast<size_t>(b0 + b) * T + t;
          const bool valid = t < len[r];
          a.y[row * H + u] = valid ? hnew : 0.f;
          if (valid && a.gates != nullptr) {
            float* gp = a.gates + row * 4 * H + u;
            gp[0] = rg;
            gp[H] = zg;
            gp[2 * H] = ng;
            gp[3 * H] = hnb;
          }
          hn[u * BG + b] = valid ? hnew : hold[r][i];
        }
      }
    }
    if (t + 1 == T) break;
#pragma unroll
    for (int r = 0; r < kRW; ++r)
#pragma unroll
      for (int i = 0; i < UPT; ++i)
#pragma unroll
        for (int g = 0; g < 3; ++g) xc[r][i][g] = xn[r][i][g];
    __syncthreads();

    // the block's units' new h, all BG rows (zero past the batch), to
    // every other block of the cluster, 16 bytes a send where aligned
    const float* const mine = hn + u0 * BG;
    if (aligned) {
#pragma unroll
      for (int q = 0; q < kSends; ++q) {
        if (q < nsend) {
          const float4 v = reinterpret_cast<const float4*>(mine)[so[q]];
          send4(p ? sa0[q] : sa1[q], v.x, v.y, v.z, v.w, p ? sb0[q] : sb1[q]);
        }
      }
    } else {
      const uint32_t own = smem_u32(mine), bar = smem_u32(&full[p ^ 1]);
      const int n2 = nu * BG / 2;
      for (int e = threadIdx.x; e < n2 * (cs - 1); e += kThreads) {
        const int d = e / n2, off = e - d * n2, dst = d < rank ? d : d + 1;
        const float2 v = reinterpret_cast<const float2*>(mine)[off];
        send2(peer(own + 8 * off, dst), v.x, v.y, peer(bar, dst));
      }
    }
  }
  cluster.sync();  // no block leaves while a peer may still write to it
}

// Grid and cluster as the forward's. Shared memory, in floats: the weight
// slice [96 UPT][H] (SMEM only), the shares of dh [2][cs][32 UPT][BG]
// (double-buffered: from block s, row b of own slot e at (s 32 UPT + e) BG
// + b), the block's dhh [96 UPT][BG]; and the two buffers' mbarriers.
// Shares sent at frame t go to buffer t & 1; as in the forward, a block
// writes a peer's buffer only after the peer's shares of the next frame,
// sent after its every warp read that buffer, have reached it.
template <int UPT, int BG, bool SMEM>
__global__ void __launch_bounds__(kThreads, 1) gru_bwd_kernel(BwdArgs a) {
  constexpr int kRow = 96 * UPT;  // the block's rows: UPT x 32 slots x 3 gates
  constexpr int kUp = 32 * UPT;   // the block's unit slots
  constexpr int kKPT = 16 * UPT / kWarps;  // units a thread takes in W_own^T dhh (H <= 512 UPT)
  constexpr int kRW = (BG + kWarps - 1) / kWarps;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int B = a.B, T = a.T, H = a.H, cs = a.cs, U = a.U;
  const int b0 = blockIdx.y * BG;
  const int u0 = rank * U;
  const int nu = max(0, min(U, H - u0));

  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const recv = smem + (SMEM ? kRow * H : 0);
  float* const dloc = recv + 2 * cs * kUp * BG;
  __shared__ uint64_t full[2];  // the shares sent at frame t complete in buffer t & 1
  if (threadIdx.x == 0) {
    bar_init(smem_u32(&full[0]));
    bar_init(smem_u32(&full[1]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const uint32_t expect = static_cast<uint32_t>(cs * nu * BG * 4);  // every block's share
  uint32_t phases = 0;  // bit q: the parity of buffer q's next phase
  const float* const wsrc = a.w + static_cast<size_t>(rank) * kRow * H;
  if constexpr (SMEM) {
    const float4* s = reinterpret_cast<const float4*>(wsrc);
    float4* d = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < kRow * H / 4; i += kThreads) d[i] = __ldg(s + i);
  }
  const float* const w = SMEM ? smem : wsrc;

  int len[kRW];
  bool live[kRW][UPT];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const int bg = b0 + warp + kWarps * r;
    len[r] = (warp + kWarps * r < BG && bg < B) ? clamp_len(a.lengths[bg], T) : 0;
#pragma unroll
    for (int i = 0; i < UPT; ++i) live[r][i] = lane + 32 * i < nu && len[r] > 0;
  }

  // a valid frame's inputs of the gate side, loaded a frame ahead:
  // dy, h_{t-1}, r, z, n, W_hn h + b_hn
  float in_c[kRW][UPT][6], in_n[kRW][UPT][6];
  auto load_in = [&](float (&x)[kRW][UPT][6], int t) {
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        const bool valid = live[r][i] && t < len[r];
        const size_t row = static_cast<size_t>(b0 + warp + kWarps * r) * T + t;
        const int u = u0 + lane + 32 * i;
        x[r][i][0] = valid ? __ldg(a.dy + row * H + u) : 0.f;
        x[r][i][1] = valid && t > 0 ? __ldg(a.y + (row - 1) * H + u) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) x[r][i][2 + q] = valid ? __ldg(a.gates + row * 4 * H + q * H + u) : 0.f;
      }
    }
  };
  load_in(in_c, T - 1);

  float dc[kRW][UPT];  // the carry's gradient that skips W_hh: g z, or all of it past the length
#pragma unroll
  for (int r = 0; r < kRW; ++r)
#pragma unroll
    for (int i = 0; i < UPT; ++i) dc[r][i] = 0.f;
  cluster.sync();  // every block of the cluster has started and set its barriers

  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) load_in(in_n, t - 1);
    const int q = (t + 1) & 1;
    const float* const shares = recv + q * cs * kUp * BG;  // sent at frame t + 1
    if (t + 1 < T) {
      if (threadIdx.x == 0) bar_expect(smem_u32(&full[q]), expect);
      bar_wait(smem_u32(&full[q]), (phases >> q) & 1);
      phases ^= 1u << q;
      __syncthreads();  // and every warp has read dhh of frame t + 1
    }

    // the gate side: dxi, dhh and the carry's gradient of the block's units
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int b = warp + kWarps * r;
      if (b >= BG) break;
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        const int slot = lane + 32 * i;
        float d[3] = {0.f, 0.f, 0.f};
        if (slot < nu && b0 + b < B) {
          const int u = u0 + slot;
          float dh = dc[r][i];
          if (t + 1 < T) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
            for (int s = 0; s < cs; ++s) part[s & 3] += shares[(s * kUp + slot) * BG + b];
            dh += (part[0] + part[1]) + (part[2] + part[3]);
          }
          const size_t row = static_cast<size_t>(b0 + b) * T + t;
          float* const dxp = a.dxi + row * 3 * H + u;
          float* const dhp = a.dhh + row * 3 * H + u;
          if (t < len[r]) {
            const float g = in_c[r][i][0] + dh;
            const float rg = in_c[r][i][2], zg = in_c[r][i][3], ng = in_c[r][i][4];
            const float dn = g * (1.f - zg) * (1.f - ng * ng);
            const float dz = g * (in_c[r][i][1] - ng) * zg * (1.f - zg);
            const float hnb = in_c[r][i][5];
            const float dr = dn * hnb * rg * (1.f - rg);
            d[0] = dr;
            d[1] = dz;
            d[2] = dn * rg;
            dxp[0] = dr;
            dxp[H] = dz;
            dxp[2 * H] = dn;
            dc[r][i] = g * zg;
          } else {  // past the length: no gate gradients, the carry's passes through
            dxp[0] = 0.f;
            dxp[H] = 0.f;
            dxp[2 * H] = 0.f;
            dc[r][i] = dh;
          }
          dhp[0] = d[0];
          dhp[H] = d[1];
          dhp[2 * H] = d[2];
        }
#pragma unroll
        for (int g = 0; g < 3; ++g) dloc[(96 * i + 3 * lane + g) * BG + b] = d[g];
      }
    }
    if (t == 0) break;  // no gradient into the zero initial carry
#pragma unroll
    for (int r = 0; r < kRW; ++r)
#pragma unroll
      for (int i = 0; i < UPT; ++i)
#pragma unroll
        for (int v = 0; v < 6; ++v) in_c[r][i][v] = in_n[r][i][v];
    __syncthreads();

    const uint32_t mine = smem_u32(recv + (t & 1) * cs * kUp * BG + rank * kUp * BG);
    const uint32_t bar = smem_u32(&full[t & 1]);
    if (UPT == 1 && H % 4 == 0) {
      // W_own^T dhh, this block's share of dh_{t-1}: a lane takes kL units
      // (a = lane & 7: units 32 kNQ warp + 32 q + 4 a .. + 3, q < kNQ, so
      // that 8 lanes read 128 consecutive bytes) over every fourth row
      // (c = lane >> 3): kNQ 16-byte reads of W and BG / 2 reads of dhh (8
      // lanes a value) feed kL BG FMAs
      constexpr int kNQ = 16 / kWarps;  // 16-byte pieces of a W row a lane reads
      constexpr int kL = 4 * kNQ;       // units a lane sums over its rows
      constexpr int kF = kL / 4;        // units a lane ends with
      const int a = lane & 7, c = lane >> 3;
      const int k0 = 32 * kNQ * warp + 4 * a;
      float acc[kL][BG];
#pragma unroll
      for (int m = 0; m < kL; ++m)
#pragma unroll
        for (int b = 0; b < BG; ++b) acc[m][b] = 0.f;
      float wc[kL], dv[BG], wn[kL], dw[BG];
      auto load_j = [&](float (&wv)[kL], float (&d)[BG], int j) {
        const float* const wr = w + static_cast<size_t>(j) * H + k0;
#pragma unroll
        for (int q = 0; q < kNQ; ++q) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k0 + 32 * q < H) x = SMEM ? reinterpret_cast<const float4*>(wr + 32 * q)[0]
                                       : __ldg(reinterpret_cast<const float4*>(wr + 32 * q));
          wv[4 * q] = x.x;
          wv[4 * q + 1] = x.y;
          wv[4 * q + 2] = x.z;
          wv[4 * q + 3] = x.w;
        }
        load_rows<BG>(d, dloc + j * BG);
      };
      const int rows = 3 * nu;
      int j = c;
      if (j < rows) load_j(wc, dv, j);
#pragma unroll 2
      for (; j < rows; j += 4) {
        load_j(wn, dw, j + 4 < rows ? j + 4 : j);  // the next row's loads in flight
#pragma unroll
        for (int m = 0; m < kL; ++m)
#pragma unroll
          for (int b = 0; b < BG; ++b) acc[m][b] = fmaf(wc[m], dv[b], acc[m][b]);
#pragma unroll
        for (int m = 0; m < kL; ++m) wc[m] = wn[m];
#pragma unroll
        for (int b = 0; b < BG; ++b) dv[b] = dw[b];
      }
      // the sum over the 4 lanes of a unit block, halving the units
      // twice: lane (a, c) ends with kF consecutive units from kq
      const int hi = (c >> 1) & 1, lo = c & 1;
      float s2[kL / 2][BG], s1[kF][BG];
#pragma unroll
      for (int m = 0; m < kL / 2; ++m)
#pragma unroll
        for (int b = 0; b < BG; ++b) {
          const float send = hi ? acc[m][b] : acc[kL / 2 + m][b];
          s2[m][b] = (hi ? acc[kL / 2 + m][b] : acc[m][b]) + __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
      for (int m = 0; m < kF; ++m)
#pragma unroll
        for (int b = 0; b < BG; ++b) {
          const float send = lo ? s2[m][b] : s2[kF + m][b];
          s1[m][b] = (lo ? s2[kF + m][b] : s2[m][b]) + __shfl_xor_sync(0xffffffffu, send, 8);
        }
      const int mstart = kL / 2 * hi + kF * lo;
      const int kq = k0 + 32 * (mstart / 4) + mstart % 4;
      // each unit's share to the block that owns it: the kF units' rows in
      // 16-byte pieces where they share an owner, else unit by unit
      if (kq < H && U % kF == 0 && (kF * BG) % 4 == 0) {
        const int owner = kq / U;
        const uint32_t at = peer(mine + 4 * (kq - owner * U) * BG, owner), ob = peer(bar, owner);
#pragma unroll
        for (int f = 0; f < kF * BG / 4; ++f) {
          send4(at + 16 * f, s1[(4 * f) / BG][(4 * f) % BG], s1[(4 * f + 1) / BG][(4 * f + 1) % BG],
                s1[(4 * f + 2) / BG][(4 * f + 2) % BG], s1[(4 * f + 3) / BG][(4 * f + 3) % BG], ob);
        }
      } else {
#pragma unroll
        for (int m = 0; m < kF; ++m) {
          if (kq + m < H) {
            const int owner = (kq + m) / U;
            send_rows<BG>(peer(mine + 4 * (kq + m - owner * U) * BG, owner), s1[m], peer(bar, owner));
          }
        }
      }
    } else {
      // W_own^T dhh: this block's share of dh_{t-1}, units warp 32 + lane + 32 kWarps m
      float acc[kKPT][BG];
#pragma unroll
      for (int m = 0; m < kKPT; ++m)
#pragma unroll
        for (int b = 0; b < BG; ++b) acc[m][b] = 0.f;
      // over the block's valid rows in groups of kGroup, the next group's
      // loads in flight while this group's FMAs run
      const int kbase = warp * 32 + lane;
      auto load_grp = [&](BwdGroup<BG, kKPT, kGroup>& q, int j0) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          load_rows<BG>(q.d[u], dloc + (j0 + u) * BG);
          const float* const wr = w + static_cast<size_t>(j0 + u) * H;
#pragma unroll
          for (int m = 0; m < kKPT; ++m) {
            const int k = kbase + 32 * kWarps * m;
            q.w[u][m] = k < H ? (SMEM ? wr[k] : __ldg(wr + k)) : 0.f;
          }
        }
      };
      auto fma_grp = [&](const BwdGroup<BG, kKPT, kGroup>& q) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
#pragma unroll
          for (int m = 0; m < kKPT; ++m)
#pragma unroll
            for (int b = 0; b < BG; ++b) acc[m][b] = fmaf(q.w[u][m], q.d[u][b], acc[m][b]);
      };
#pragma unroll
      for (int i = 0; i < UPT; ++i) {
        int j = 96 * i;
        const int jend = j + 3 * max(0, min(32, nu - 32 * i));
        const int jfull = j + (jend - j) / kGroup * kGroup;
        if (j < jfull) {
          BwdGroup<BG, kKPT, kGroup> cur, nxt;
          load_grp(cur, j);
          for (; j + kGroup < jfull; j += kGroup) {
            load_grp(nxt, j + kGroup);
            fma_grp(cur);
            cur = nxt;
          }
          fma_grp(cur);
          j += kGroup;
        }
        for (; j < jend; ++j) {  // the rows past the last whole group
          float dv[BG];
          load_rows<BG>(dv, dloc + j * BG);
          const float* const wr = w + static_cast<size_t>(j) * H;
#pragma unroll
          for (int m = 0; m < kKPT; ++m) {
            const int k = kbase + 32 * kWarps * m;
            const float wv = k < H ? (SMEM ? wr[k] : __ldg(wr + k)) : 0.f;
#pragma unroll
            for (int b = 0; b < BG; ++b) acc[m][b] = fmaf(wv, dv[b], acc[m][b]);
          }
        }
      }
      // each unit's share to the block that owns it
#pragma unroll
      for (int m = 0; m < kKPT; ++m) {
        const int k = warp * 32 + lane + 32 * kWarps * m;
        if (k < H) {
          const int c = k / U;
          send_rows<BG>(peer(mine + 4 * (k - c * U) * BG, c), acc[m], peer(bar, c));
        }
      }
    }
  }
  cluster.sync();  // no block leaves while a peer may still write to it
}

// A block's dynamic shared memory in bytes, as the kernels above carve
// it: the weight slice if it sits there; forward h [2][H][BG] and the
// partial sums [kRedSlots][96 UPT][BG], backward the shares of dh
// [2][cs][32 UPT][BG] and dhh [96 UPT][BG].
template <int UPT, int BG, bool SMEM>
long long smem_bytes(bool backward, int H, int cs) {
  const long long rows = 96 * UPT;
  const long long floats = backward ? 2LL * cs * 32 * UPT * BG + rows * BG
                                    : 2LL * H * BG + kRedSlots * rows * BG;
  return 4 * (floats + (SMEM ? rows * H : 0));
}

// The launch of one direction's kernel: ceil(B / BG) clusters of cs
// blocks, the shared memory smem_bytes; cudaErrorInvalidValue where that
// exceeds a block's.
template <int UPT, int BG, bool SMEM, typename Args>
int launch(void (*kernel)(Args), bool backward, const Args& a, cudaStream_t stream) {
  const long long smem = smem_bytes<UPT, BG, SMEM>(backward, a.H, a.cs);
  const int clusters = (a.B + BG - 1) / BG;
  if (smem > kMaxSmem || clusters > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cs, clusters, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int K3_NAME(fwd, K3_UPT, K3_BG, K3_SMEM)(const FwdArgs* a, cudaStream_t stream) {
  return launch<K3_UPT, K3_BG, K3_SMEM != 0>(gru_fwd_kernel<K3_UPT, K3_BG, K3_SMEM != 0>, false,
                                             *a, stream);
}

extern "C" int K3_NAME(bwd, K3_UPT, K3_BG, K3_SMEM)(const BwdArgs* a, cudaStream_t stream) {
  return launch<K3_UPT, K3_BG, K3_SMEM != 0>(gru_bwd_kernel<K3_UPT, K3_BG, K3_SMEM != 0>, true,
                                             *a, stream);
}

#else  // the C entry points

namespace {

// The launch's shape, as the host laid out the weights: cs in {1, 2, 4,
// 8, 16} blocks of U = ceil(H / cs) units, U <= 32 upt; upt one of
// K3_CONFIG_LIST's.
bool valid_plan(int B, int T, int H, int cs, int upt) {
  if (B < 1 || T < 1 || H < 1 || !(cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == 16)) {
    return false;
  }
  return (H + cs - 1) / cs <= 32 * upt;
}

}  // namespace

extern "C" {

// The forward, launched on `stream`; returns the cudaError_t of the launch
// (0 on success). xi (B, T, 3H), y (B, T, H), gates (B, T, 4H) or null, f32
// contiguous; w: the blocks' weight slices (cs, H, 96 upt) of U = ceil(H /
// cs) units each; bias_hn (H,); lengths (B,) int64. A plan that is not
// valid_plan, or an upt no instantiation takes, returns
// cudaErrorInvalidValue.
int gru_scan_f32(const void* xi, const void* w, const void* bias_hn, const void* lengths, int B,
                 int T, int H, int cs, int upt, void* y, void* gates, void* stream) {
  if (!valid_plan(B, T, H, cs, upt)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a = {static_cast<const float*>(xi), static_cast<const float*>(w),
                     static_cast<const float*>(bias_hn), static_cast<const int64_t*>(lengths),
                     static_cast<float*>(y), static_cast<float*>(gates), B, T, H, cs,
                     (H + cs - 1) / cs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K3_FWD_CASE(U_, B_, S_) \
  if (upt == U_) return K3_NAME(fwd, U_, B_, S_)(&a, st);
  K3_CONFIG_LIST(K3_FWD_CASE)
#undef K3_FWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward, as the forward: dy and y (B, T, H), gates (B, T, 4H), dxi
// and dhh (B, T, 3H), f32 contiguous; w: the blocks' weight slices (cs,
// 96 upt, H).
int gru_scan_bwd_f32(const void* dy, const void* y, const void* gates, const void* w,
                     const void* lengths, int B, int T, int H, int cs, int upt, void* dxi,
                     void* dhh, void* stream) {
  if (!valid_plan(B, T, H, cs, upt)) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a = {static_cast<const float*>(dy), static_cast<const float*>(y),
                     static_cast<const float*>(gates), static_cast<const float*>(w),
                     static_cast<const int64_t*>(lengths), static_cast<float*>(dxi),
                     static_cast<float*>(dhh), B, T, H, cs, (H + cs - 1) / cs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K3_BWD_CASE(U_, B_, S_) \
  if (upt == U_) return K3_NAME(bwd, U_, B_, S_)(&a, st);
  K3_CONFIG_LIST(K3_BWD_CASE)
#undef K3_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // K3_UPT
