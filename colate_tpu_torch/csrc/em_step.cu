// K fused float32 EM iterations for a batch of bootstrap replicates.
//
// Replaces colate_tpu/ops/em_pallas.py:_make_kernel (the fused Pallas TPU
// kernel launched by _pallas_step).  Per iteration and per replicate:
// epoch tables (cumulative hazard H, survival S, P, T1, 1/lambda), the
// point-age E-step over all age bins (the shared T<t branch and the
// hazard-relative notshared T>t branch, each with exclusive suffix sums),
// the count-weighted reduction to per-epoch num/den, and the M-step
// (floor at the rate floor, den==0 keeps the old rate, num==0 fills the
// previous epoch's new rate forward).  The K-th E-step also writes the
// per-bin log-likelihood terms; the caller sums them in float64.
//
// What bounds it on an H100: latency, not bytes or flops.  One iteration
// is ~B*185*E*40 flops on [B,E] state, so a B=1024 chunk moves well under
// a megabyte and does a few GFLOP at most.  The time goes into the
// sequential recurrences over epochs (the hazard prefix, the suffix sums,
// the fill-forward), the barriers between the phases of an iteration, and
// the host sync once per K iterations for the stopping rule.
//
// What the design does about it:
// - one CTA per replicate, 192 threads, thread n owns age bin n (bins
//   185..191 idle); a replicate never waits on another.  At 50 registers a
//   thread (ptxas, sm_90a) six CTAs fit on an SM, so up to 792 replicates
//   run in one wave on 132 SMs;
// - all K iterations loop inside the kernel with the rates in shared
//   memory, so a launch (and a host round trip) covers K iterations;
// - the per-epoch tables are built once per iteration by one thread's
//   sequential scan into shared memory; every bin thread then walks the
//   epochs itself (forward for the notshared normaliser, backward for the
//   suffix sums) and needs no per-epoch arrays in registers;
// - num/den are reduced across bins by a fixed-order warp-shuffle tree and
//   a fixed-order sum over the six warps: no atomics, so a replicate's
//   result is bitwise independent of B and of how replicates are split
//   across launches or devices.
//
// The TPU kernel's one-hot MXU gathers, Hillis-Steele doubling and Taylor
// series for 1-exp(-x) are Mosaic workarounds and are not carried over:
// this kernel indexes directly and uses expm1f.  It must be built without
// --use_fast_math: the stopping rule compares float64 sums of these float32
// terms against a 1e-7 ratio.

#include <cuda_runtime.h>

#define EM_THREADS 192
#define EM_WARPS (EM_THREADS / 32)
#define EM_MAX_EPOCHS 256

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  // fixed pairing: lane 0 ends with the same rounding on every launch
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// max(x, 0) that keeps a NaN, like jnp.clip in the reference
__device__ __forceinline__ float clip0(float x) { return x < 0.f ? 0.f : x; }

__global__ void __launch_bounds__(EM_THREADS)
em_step_kernel(const float* __restrict__ rates_in,   // [B, E]
               const float* __restrict__ sc,         // [B, N]
               const float* __restrict__ nc,         // [B, N]
               const float* __restrict__ t_bin,      // [N] bin age t
               const float* __restrict__ tmk_bin,    // [N] t - epochs[k]
               const float* __restrict__ tk1_bin,    // [N] epochs[min(k+1, E-1)]
               const int* __restrict__ k_bin,        // [N] epoch index of t
               const float* __restrict__ epochs_g,   // [E]
               const float* __restrict__ dt_g,       // [E] widths, 0 for the last
               const float* __restrict__ enext_g,    // [E] epochs[e+1], 0 for the last
               float* __restrict__ rates_out,        // [B, E]
               float* __restrict__ wsum,             // [B, N]
               int E, int N, int K, float rate_floor) {
  extern __shared__ float smem[];
  float* s_ep = smem;
  float* s_dt = s_ep + E;
  float* s_en = s_dt + E;
  float* s_lam = s_en + E;   // current rates
  float* s_H = s_lam + E;    // cumulative hazard at epoch starts
  float* s_S = s_H + E;      // exp(-H)
  float* s_P = s_S + E;      // P(T in e)
  float* s_T1 = s_P + E;     // E[T 1{T in e}]
  float* s_inv = s_T1 + E;   // 1/lambda (0 where lambda == 0)
  float* s_em1 = s_inv + E;  // 1-exp(-lambda dt), 1 for the last epoch
  float* s_pnum = s_em1 + E;              // [EM_WARPS, E] warp partials
  float* s_pden = s_pnum + EM_WARPS * E;  // [EM_WARPS, E]
  float* s_num = s_pden + EM_WARPS * E;   // [E]
  float* s_den = s_num + E;               // [E]

  const int b = blockIdx.x;
  const int n = threadIdx.x;
  const int lane = n & 31;
  const int warp = n >> 5;

  for (int e = n; e < E; e += EM_THREADS) {
    s_ep[e] = epochs_g[e];
    s_dt[e] = dt_g[e];
    s_en[e] = enext_g[e];
    s_lam[e] = rates_in[(size_t)b * E + e];
  }
  const bool active = n < N;
  float t = 0.f, tmk = 0.f, tk1 = 0.f, w_s = 0.f, w_n = 0.f;
  int k = 0;
  if (active) {
    t = t_bin[n];
    tmk = tmk_bin[n];
    tk1 = tk1_bin[n];
    k = k_bin[n];
    w_s = sc[(size_t)b * N + n];
    w_n = nc[(size_t)b * N + n];
  }
  const bool klt = k < E - 1;
  __syncthreads();

  for (int it = 0; it < K; ++it) {
    // ---- epoch tables: one thread, sequential hazard prefix ----
    if (n == 0) {
      float H = 0.f;
      for (int e = 0; e < E; ++e) {
        const float lam = s_lam[e];
        const bool last = e == E - 1;
        const bool pos = lam > 0.f;
        const float dH = lam * s_dt[e];
        const float S = expf(-H);
        const float em1 = -expm1f(-dH);
        const float inv = pos ? 1.f / lam : 0.f;
        const float T1 = last ? (s_ep[e] + inv) * S
                              : S * ((s_en[e] + inv) * em1 - s_dt[e]);
        s_H[e] = H;
        s_S[e] = S;
        s_P[e] = last ? (pos ? S : 0.f) : S * em1;
        s_T1[e] = pos ? T1 : 0.f;
        s_inv[e] = inv;
        s_em1[e] = last ? 1.f : em1;
        H += dH;
      }
    }
    __syncthreads();

    // ---- per-bin terms that do not depend on the epoch e ----
    const float lam_k = s_lam[k];
    const float H_k = s_H[k];
    const float S_k = s_S[k];
    const float inv_k = s_inv[k];
    const bool lam_k_pos = lam_k > 0.f;
    // shared: T < t
    const float dH_lo = lam_k * tmk;
    const float H_t = H_k + dH_lo;
    const float em1_lo = -expm1f(-dH_lo);
    const float Pk_minus = S_k * em1_lo;
    const float T1k_minus = lam_k_pos ? S_k * ((t + inv_k) * em1_lo - tmk) : 0.f;
    const float Z_s = -expm1f(-H_t);
    const bool guard_s = Z_s > 0.f;
    const float zinv = guard_s ? 1.f / Z_s : 0.f;
    // notshared: T > t, hazard-relative (exp(-H_t) factored out)
    const float dH_hi = klt ? lam_k * (tk1 - t) : 0.f;
    const float em1_hi = -expm1f(-dH_hi);
    const float Pk_plus = klt ? em1_hi : (lam_k_pos ? 1.f : 0.f);
    const float T1k_plus =
        klt ? (lam_k_pos ? (tk1 + inv_k) * em1_hi - (tk1 - t) : 0.f)
            : (lam_k_pos ? t + inv_k : 0.f);

    // forward walk: total absorbed mass zrel
    float zrel = Pk_plus;
    for (int e = k + 1; e < E; ++e) {
      const float Srel = expf(-(s_H[e] - H_t));
      zrel += (e == E - 1) ? (s_lam[e] > 0.f ? Srel : 0.f) : Srel * s_em1[e];
    }
    const bool guard_n = zrel > 0.f;
    const float zrel_inv = guard_n ? 1.f / zrel : 0.f;

    // backward walk (uniform over the block): suffix sums, posteriors,
    // exposures and the warp-level count-weighted reduction per epoch
    float suf_s = 0.f, suf_n = 0.f;
    for (int e = E - 1; e >= 0; --e) {
      const float ep = s_ep[e];
      const float dt = s_dt[e];
      float num_lin = 0.f, T1v = 0.f;
      if (e < k) {
        num_lin = s_P[e];
        T1v = s_T1[e];
      } else if (e == k) {
        num_lin = Pk_minus;
        T1v = T1k_minus;
      }
      suf_s += num_lin;
      float num_s = 0.f, den_s = 0.f;
      if (guard_s) {
        const float post = num_lin * zinv;
        const float texp = T1v * zinv;
        const float integ = (suf_s - num_lin) * zinv;
        num_s = post;
        den_s = e <= k ? clip0(texp - ep * post + dt * integ) : 0.f;
      }

      float raw_n = 0.f, raw_t = 0.f;
      if (e == k) {
        raw_n = Pk_plus;
        raw_t = T1k_plus;
      } else if (e > k) {
        const float lam = s_lam[e];
        const float inv = s_inv[e];
        const float Srel = expf(-(s_H[e] - H_t));
        const bool last = e == E - 1;
        raw_n = last ? (lam > 0.f ? Srel : 0.f) : Srel * s_em1[e];
        const float T1r = last ? (ep + inv) * Srel
                               : Srel * ((s_en[e] + inv) * s_em1[e] - dt);
        raw_t = lam > 0.f ? T1r : 0.f;
      }
      suf_n += raw_n;
      float num_n = 0.f, den_n = 0.f;
      if (guard_n) {
        const float post_n = raw_n * zrel_inv;
        const float texp_n = raw_t * zrel_inv;
        const float integ_n = (suf_n - raw_n) * zrel_inv;
        num_n = post_n;
        den_n = clip0(texp_n - ep * post_n + dt * integ_n);
      }

      float tn = 0.f, td = 0.f;
      if (active) {
        tn = w_s * num_s + w_n * num_n;
        td = w_s * den_s + w_n * den_n;
      }
      tn = warp_sum(tn);
      td = warp_sum(td);
      if (lane == 0) {
        s_pnum[warp * E + e] = tn;
        s_pden[warp * E + e] = td;
      }
    }
    if (it == K - 1 && active) {
      const float logl_s = guard_s ? logf(Z_s) : 0.f;
      const float logl_n = guard_n ? logf(zrel) - H_t : 0.f;
      wsum[(size_t)b * N + n] = w_s * logl_s + w_n * logl_n;
    }
    __syncthreads();

    for (int e = n; e < E; e += EM_THREADS) {
      float num = 0.f, den = 0.f;
      for (int w = 0; w < EM_WARPS; ++w) {
        num += s_pnum[w * E + e];
        den += s_pden[w * E + e];
      }
      s_num[e] = num;
      s_den[e] = den;
    }
    __syncthreads();

    // ---- M-step: one thread, sequential fill-forward ----
    if (n == 0) {
      float prev = 0.f;
      for (int e = 0; e < E; ++e) {
        const float num = s_num[e];
        const float den = s_den[e];
        const bool den_pos = den > 0.f;
        float ratio = den_pos ? num / den : 0.f;
        ratio = ratio < rate_floor ? rate_floor : ratio;
        const float chosen = den_pos ? ratio : s_lam[e];
        const float v = num != 0.f ? chosen : prev;
        s_lam[e] = v;
        prev = v;
      }
    }
    __syncthreads();
  }

  for (int e = n; e < E; e += EM_THREADS) rates_out[(size_t)b * E + e] = s_lam[e];
}

}  // namespace

extern "C" {

int em_step_max_epochs(void) { return EM_MAX_EPOCHS; }

const char* em_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches K iterations for B replicates on `stream`; returns the CUDA
// error of the launch (0 on success).  Does not synchronise.
int em_step_f32(const float* rates_in, const float* sc, const float* nc,
                const float* t_bin, const float* tmk_bin, const float* tk1_bin,
                const int* k_bin, const float* epochs, const float* dt,
                const float* enext, float* rates_out, float* wsum, int B, int E,
                int N, int K, float rate_floor, void* stream) {
  if (B < 1 || E < 1 || E > EM_MAX_EPOCHS || N < 1 || N > EM_THREADS || K < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(10 + 2 * EM_WARPS + 2) * E * sizeof(float);
  em_step_kernel<<<B, EM_THREADS, smem, (cudaStream_t)stream>>>(
      rates_in, sc, nc, t_bin, tmk_bin, tk1_bin, k_bin, epochs, dt, enext,
      rates_out, wsum, E, N, K, rate_floor);
  return (int)cudaGetLastError();
}

}  // extern "C"
