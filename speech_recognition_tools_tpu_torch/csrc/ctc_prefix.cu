// CTC prefix scores of every single-token extension of K prefixes of B
// utterances (kernel K2): one thread per chain (b, k, c), the frame
// recursion in registers, one launch a search step.
//
// Computes the function of ctc_prefix_scores_reference() in
// decode/ctc_prefix.py. For the chain that extends prefix k of utterance b
// by token c, over the valid frames t < enc_len[b]:
//
//   phi_t = r_b'[t-1]                        if c is the prefix's last token
//           logaddexp(r_nb'[t-1], r_b'[t-1])  otherwise
//           (at t = 0: 0 for the empty prefix, NEG_INF for any other)
//   nb_t  = logaddexp(nb_{t-1}, phi_t) + logp[b, t, c]
//   b_t   = logaddexp(nb_{t-1}, b_{t-1}) + logp[b, t, blank]
//   psi   = logsumexp_t (phi_t + logp[b, t, c])
//   full  = logaddexp(nb, b) at the last valid frame
//
// where r' is the prefix's own forward variables (r_prev), nb and b start
// at NEG_INF, and past enc_len[b] (nb, b) hold their last valid values, as
// the plain version's where(keep) holds them. NEG_INF (-1e30) is log 0 with
// the plain version's meaning: a logaddexp whose larger term is at or below
// it is exactly NEG_INF, and adding a log-probability leaves it there.
// Accurate expf / logf, no fast-math intrinsics; float32 throughout.
//
// It replaces no Pallas kernel. The JAX package runs this recursion as one
// lax.scan (speech_recognition_tools_tpu/decode/ctc_prefix.py), which XLA
// compiles into one loop on the TPU; the port's plain version walks the
// frames in a Python loop of ~14 launches a frame over (2, B, K, V), ~4,200
// launches a search step at ~300 frames, and those launches bound the step.
//
// What bounds it on an H100: at the decode cell's longest batch (B 8, K 10,
// V 52, T 303) it reads ~0.7 MB (logp and r_prev) and writes r_new, 2 T B K V
// floats (~10.1 MB): ~3.2 us at 3.35 TB/s; its ~2.5e7 operations take under
// 1 us at 67 TFLOP/s. In practice the serial chain over the frames sets its
// time, far above either: every frame's nb_t needs nb_{t-1} through an
// expf, a logf and three adds, and a warp runs each frame's three
// logaddexps and psi's expf in turn.
//
// Design.
// - One thread per chain, so the only serial work is the frame chain
//   itself; B K V chains (4,160 in the cell) are less than one wave of
//   warps.
// - Nothing a frame reads depends on the chain: logp[b, t, c] (coalesced
//   across c), logp[b, t, blank] and r_prev[b, k, t-1, :] (broadcast). They
//   are loaded kChunk frames ahead into registers, so each chunk's loads are
//   in flight while the previous chunk's frames are computed.
// - A single warp per scheduler cannot hide instruction latency, so the
//   time is the dependent path through the frames. A chunk's frames are
//   straight-line code (logaddexp and the psi update are branch-free), so
//   the compiler interleaves the work off the non-blank chain (phi, psi,
//   the blank chain, the stores) with it.
// - phi_t and the psi terms are formed in the thread from r_prev; psi is an
//   online logsumexp (running maximum and rescaled sum) in the same pass.
// - r_new is written in (T, 2, B, K, V) layout, the plain version's
//   torch.stack layout: neighbouring threads store neighbouring addresses.
//   The wrapper returns the same (B, K, V, T, 2) view of it.
// - r_prev's (T, 2) rows are contiguous; its utterance and beam strides are
//   arguments, so the search's first step reads init_prefix_state's
//   expanded view (beam stride 0) as it is.
// - No shared memory, tensor cores or TMA: no operand is shared by enough
//   threads, or large enough, for either to matter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kChunk = 8;  // frames loaded ahead of the chain
// A chain's frames are serial, so its time does not depend on how its
// warps share the SMs: 32 to 128 threads a block time alike.
constexpr int kThreads = 128;

// Branch-free, so that the compiler can interleave the independent work
// of a chunk's frames (phi, psi, the blank chain) with the non-blank chain.
// log(1 + e) as the plain version forms it (log(exp(0) + exp(d))): closer
// to it than log1pf, and shorter.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float r = m + logf(1.f + expf(fminf(a, b) - m));
  return m <= kNegInf ? kNegInf : r;
}

struct Chain {
  float nb = kNegInf, bl = kNegInf;  // forward variables: ending in c, in blank
  float m = kNegInf, s = 0.f;        // psi's running maximum and rescaled sum

  // One valid frame; out points at r_new[t, 0, chain], `half` floats
  // before r_new[t, 1, chain].
  __device__ __forceinline__ void frame(float phi, float lp_c, float lp_b, float* out,
                                        long long half) {
    const float nb_t = logaddexp(nb, phi) + lp_c;
    bl = logaddexp(nb, bl) + lp_b;
    nb = nb_t;
    out[0] = nb;
    out[half] = bl;
    const float x = phi + lp_c;
    const float e = expf(-fabsf(x - m));
    s = x > m ? fmaf(s, e, 1.f) : s + e;
    m = fmaxf(m, x);
  }
};

struct Frames {
  float lp_c[kChunk], lp_b[kChunk], prev_nb[kChunk], prev_b[kChunk];
};

// The inputs of frames t0 .. t0 + kChunk - 1, t0 >= 1 (those past `last`
// read frame `last` again and are not used).
__device__ __forceinline__ void load_frames(Frames& f, const float* __restrict__ lp,
                                            const float* __restrict__ rp, int t0, int last,
                                            int V, int c, int blank) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int t = min(t0 + u, last);
    f.lp_c[u] = __ldg(lp + static_cast<long long>(t) * V + c);
    f.lp_b[u] = __ldg(lp + static_cast<long long>(t) * V + blank);
    f.prev_nb[u] = __ldg(rp + 2 * (t - 1));
    f.prev_b[u] = __ldg(rp + 2 * (t - 1) + 1);
  }
}

__global__ void ctc_prefix_kernel(const float* __restrict__ logp,
                                  const int64_t* __restrict__ enc_len,
                                  const int64_t* __restrict__ prefix_lens,
                                  const int64_t* __restrict__ last_tokens,
                                  const float* __restrict__ r_prev, long long r_sb,
                                  long long r_sk, int B, int K, int V, int T, int blank,
                                  float* __restrict__ psi, float* __restrict__ full,
                                  float* __restrict__ r_new) {
  const long long n = static_cast<long long>(B) * K * V;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long bk = i / V;
  const int c = static_cast<int>(i - bk * V);
  const int b = static_cast<int>(bk / K);
  const int k = static_cast<int>(bk - static_cast<long long>(b) * K);

  const long long len = enc_len[b];
  const int L = len <= 0 ? 0 : (len >= T ? T : static_cast<int>(len));
  const bool same = last_tokens[bk] == c;
  const float* lp = logp + static_cast<long long>(b) * T * V;
  const float* rp = r_prev + b * r_sb + k * r_sk;
  float* out = r_new + i;
  const long long half = n;  // floats from r_new[t, 0, chain] to r_new[t, 1, chain]

  Chain ch;
  if (L > 0) {  // frame 0 extends from the virtual frame -1
    const float start = prefix_lens[bk] == 0 ? 0.f : kNegInf;
    ch.frame(start, __ldg(lp + c), __ldg(lp + blank), out, half);
  }
  int t0 = 1;
  Frames cur, next;
  if (L > 1) load_frames(cur, lp, rp, t0, L - 1, V, c, blank);
  for (; t0 + kChunk <= L; t0 += kChunk) {
    load_frames(next, lp, rp, t0 + kChunk, L - 1, V, c, blank);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float phi = same ? cur.prev_b[u] : logaddexp(cur.prev_nb[u], cur.prev_b[u]);
      ch.frame(phi, cur.lp_c[u], cur.lp_b[u], out + 2LL * (t0 + u) * half, half);
    }
    cur = next;
  }
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {  // the last frames, fewer than a chunk
    if (t0 + u < L) {
      const float phi = same ? cur.prev_b[u] : logaddexp(cur.prev_nb[u], cur.prev_b[u]);
      ch.frame(phi, cur.lp_c[u], cur.lp_b[u], out + 2LL * (t0 + u) * half, half);
    }
  }
  for (int t = L; t < T; ++t) {
    out[2LL * t * half] = ch.nb;
    out[(2LL * t + 1) * half] = ch.bl;
  }
  psi[i] = ch.s > 0.f ? ch.m + logf(ch.s) : kNegInf;
  full[i] = logaddexp(ch.nb, ch.bl);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 on
// success). logp: (B, T, V) f32 row-major;
// enc_len (B,), prefix_lens and last_tokens (B, K) int64 contiguous;
// r_prev: (B, K, T, 2) f32 whose (T, 2) rows are contiguous, utterance and
// beam strides r_sb, r_sk in floats; psi, full: (B, K, V) f32; r_new:
// (T, 2, B, K, V) f32. Shapes out of range return cudaErrorInvalidValue.
int ctc_prefix_f32(const void* logp, const void* enc_len, const void* prefix_lens,
                   const void* last_tokens, const void* r_prev, long long r_sb,
                   long long r_sk, int B, int K, int V, int T, int blank, void* psi,
                   void* full, void* r_new, void* stream) {
  if (B < 0 || K < 0 || V < 1 || T < 1 || blank < 0 || blank >= V || r_sb < 0 || r_sk < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(B) * K * V;
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ctc_prefix_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logp), static_cast<const int64_t*>(enc_len),
      static_cast<const int64_t*>(prefix_lens), static_cast<const int64_t*>(last_tokens),
      static_cast<const float*>(r_prev), r_sb, r_sk, B, K, V, T, blank,
      static_cast<float*>(psi), static_cast<float*>(full), static_cast<float*>(r_new));
  return static_cast<int>(cudaGetLastError());
}

const char* ctc_prefix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
