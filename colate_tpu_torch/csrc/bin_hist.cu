// Analytic age-bin histograms of a block-aligned site stream, in float32
// per 512-site chunk and float64 per block.
//
// Replaces colate_tpu/ops/bin_pallas.py:_make_fn (the fused Pallas TPU
// kernel whose body is at :89), and with it the XLA programs that compute
// the same expectation (pipeline/binning.py:_chunk_hist,
// parallel/mesh.py:_sharded_bin_fn).  For every site it spreads the site's
// weights over the 185 log-age bins as the exact expectation of the
// reference's 100-draw Monte Carlo binning (coal/coal.cpp:2244-2298):
//
// - a regular site (age_begin > age): U[max(age_begin, age), age_end]
//   conditional on landing in the table, i.e. each bin's overlap divided by
//   the in-table total s (0 when s == 0), times w_shared (histogram 0) and
//   w_notshared (histogram 1);
// - an emp site (age_begin <= age, decided on the host in float64): the
//   clamped-CDF law of max(U[age_begin, age_end], age), with the mass beyond
//   the table in the last bin, times w_notshared (histogram 1); and its
//   w_shared / w_notshared into the bin the host computed in float64 from
//   age_end (histograms 2 and 3).
//
// The stream arrives packed by ops/bin_kernel.py:pack_sites: chunks of 512
// sites that never straddle a block (colate_tpu.ops.bin_pallas.segments),
// pad lanes carrying zero weight.  Two passes:
//
// 1. chunk_hist_kernel, one CTA of 192 threads per chunk.  The chunk's
//    columns are staged in shared memory; each thread computes the
//    normaliser s of a few sites (185 overlaps summed in bin order); then
//    thread k owns bin k and walks the chunk's sites in order, accumulating
//    the four weighted terms in float32 registers, and writes the chunk's
//    [4, 185] partial.  A site is regular or emp for the whole CTA, so the
//    branch between the two laws never diverges inside a warp.
// 2. block_sum_kernel, one CTA per block, sums that block's chunk partials
//    in packed order in float64.  No atomics anywhere: a block's sums depend
//    only on its own chunks, so a stream split at block boundaries bins
//    bitwise identically (the property parallel/mesh.py relies on).
//
// What bounds it on an H100: arithmetic, not bytes.  A site is 20 bytes
// but costs 2 x 185 overlap evaluations with up to three IEEE divisions
// each.  The TPU kernel built [256, 512] matrices in VMEM and contracted
// them with a block one-hot on the MXU into a resident [cap, 1024]
// accumulator, capped at 1008 blocks; here every chunk is one block by
// construction, so no one-hot and no accumulator ladder are needed, and
// the block id rides per chunk as an int32 (no 2^24 limit of a float aux
// row).  Pad lanes are skipped (chunk_n) rather than added as +0.0.
//
// Built without --use_fast_math: p = ov / s and (e - ab) / width need
// IEEE divisions for the guards at s == 0 and width == 1e-30.

#include <cuda_runtime.h>

#define BIN_CHUNK 512
#define BIN_THREADS 192
#define BIN_NBINS 185
#define BIN_EMP 1024  // meta bit of an emp site; the low 10 bits hold its bin
#define SUM_THREADS 256

namespace {

__device__ __forceinline__ float clip01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

__global__ void __launch_bounds__(BIN_THREADS)
chunk_hist_kernel(const float* __restrict__ fv,       // [4, n_packed]
                  long long n_packed,
                  const int* __restrict__ meta,       // [n_packed]
                  const int* __restrict__ chunk_n,    // [n_chunks]
                  const float* __restrict__ edges,    // [BIN_NBINS + 1]
                  float age,
                  float* __restrict__ partial) {      // [n_chunks, 4, BIN_NBINS]
  __shared__ float s_ab[BIN_CHUNK], s_ae[BIN_CHUNK], s_ws[BIN_CHUNK], s_wn[BIN_CHUNK];
  __shared__ float s_norm[BIN_CHUNK];
  __shared__ int s_meta[BIN_CHUNK];
  __shared__ float s_edge[BIN_NBINS + 1];

  const long long c = blockIdx.x;
  const int n = chunk_n[c];
  const long long base = c * BIN_CHUNK;
  const int t = threadIdx.x;
  for (int j = t; j < n; j += BIN_THREADS) {
    s_ab[j] = fv[base + j];
    s_ae[j] = fv[n_packed + base + j];
    s_ws[j] = fv[2 * n_packed + base + j];
    s_wn[j] = fv[3 * n_packed + base + j];
    s_meta[j] = meta[base + j];
  }
  for (int k = t; k <= BIN_NBINS; k += BIN_THREADS) s_edge[k] = edges[k];
  __syncthreads();

  // in-table normaliser of each regular site, summed in bin order
  for (int j = t; j < n; j += BIN_THREADS) {
    float s = 0.f;
    if (!(s_meta[j] & BIN_EMP)) {
      const float a = fmaxf(s_ab[j], age);
      const float e = s_ae[j];
      for (int k = 0; k < BIN_NBINS; ++k) {
        const float ov = fminf(e, s_edge[k + 1]) - fmaxf(a, s_edge[k]);
        s += ov > 0.f ? ov : 0.f;
      }
    }
    s_norm[j] = s;
  }
  __syncthreads();

  if (t >= BIN_NBINS) return;
  const float elo = s_edge[t];
  const float ehi = s_edge[t + 1];
  const bool lo_in = elo > age;
  const bool hi_in = ehi > age;
  float h_s = 0.f, h_n = 0.f, h_se = 0.f, h_ne = 0.f;
  for (int j = 0; j < n; ++j) {
    const int m = s_meta[j];
    const float ab = s_ab[j];
    const float ae = s_ae[j];
    if (m & BIN_EMP) {
      const float width = fmaxf(ae - ab, 1e-30f);
      const float cl = lo_in ? clip01((elo - ab) / width) : 0.f;
      const float ch = hi_in ? clip01((ehi - ab) / width) : 0.f;
      float pe = ch - cl;
      if (t == BIN_NBINS - 1) pe += 1.f - ch;  // mass beyond the table
      h_n += pe * s_wn[j];
      if ((m & (BIN_EMP - 1)) == t) {
        h_se += s_ws[j];
        h_ne += s_wn[j];
      }
    } else {
      const float s = s_norm[j];
      const float ov = fminf(ae, ehi) - fmaxf(fmaxf(ab, age), elo);
      const float p = s > 0.f ? (ov > 0.f ? ov : 0.f) / s : 0.f;
      h_s += p * s_ws[j];
      h_n += p * s_wn[j];
    }
  }
  float* out = partial + c * 4 * BIN_NBINS;
  out[t] = h_s;
  out[BIN_NBINS + t] = h_n;
  out[2 * BIN_NBINS + t] = h_se;
  out[3 * BIN_NBINS + t] = h_ne;
}

__global__ void __launch_bounds__(SUM_THREADS)
block_sum_kernel(const float* __restrict__ partial,     // [n_chunks, 4 * BIN_NBINS]
                 const int* __restrict__ block_chunks,  // chunk ids grouped by block
                 const int* __restrict__ block_off,     // [num_blocks + 1]
                 double* __restrict__ out) {            // [num_blocks, 4 * BIN_NBINS]
  const int b = blockIdx.x;
  const int lo = block_off[b];
  const int hi = block_off[b + 1];
  for (int q = threadIdx.x; q < 4 * BIN_NBINS; q += SUM_THREADS) {
    double acc = 0.0;
    for (int i = lo; i < hi; ++i)
      acc += (double)partial[(long long)block_chunks[i] * 4 * BIN_NBINS + q];
    out[(long long)b * 4 * BIN_NBINS + q] = acc;
  }
}

}  // namespace

extern "C" {

int bin_hist_chunk(void) { return BIN_CHUNK; }

int bin_hist_nbins(void) { return BIN_NBINS; }

const char* bin_hist_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches both passes on `stream`; returns the first CUDA error (0 on
// success).  `partial` is scratch of n_chunks * 4 * 185 floats; `out`
// receives [num_blocks, 4, 185] doubles.  Does not synchronise.
int bin_hist_f32(const float* fv, const int* meta, const int* chunk_n,
                 long long n_chunks, long long n_packed, const float* edges,
                 float age, const int* block_chunks, const int* block_off,
                 int num_blocks, float* partial, double* out, void* stream) {
  if (n_chunks < 0 || n_packed != n_chunks * BIN_CHUNK || num_blocks < 0 ||
      n_chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks > 0) {
    chunk_hist_kernel<<<(unsigned)n_chunks, BIN_THREADS, 0, s>>>(
        fv, n_packed, meta, chunk_n, edges, age, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (num_blocks > 0) {
    block_sum_kernel<<<num_blocks, SUM_THREADS, 0, s>>>(partial, block_chunks,
                                                        block_off, out);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // extern "C"
