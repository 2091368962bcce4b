// Analytic age-bin histograms of a site stream, in float32 per 512-site
// chunk and float64 per block.
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
// The stream arrives as ops/bin_kernel.py:site_stream lays it out: the
// unpadded site columns in stream order (four float32 rows and an int32
// meta word: EMP | bin of age_end on emp sites), and a chunk table.  A
// chunk is up to 512 consecutive sites of one same-block run; a segment is
// up to BIN_SEG consecutive chunks of one block's chunk list.  Two passes:
//
// 1. seg_hist_kernel, one CTA of 256 threads per segment.  For each chunk:
//    every thread takes two sites, finds the bins each can touch by a
//    binary search of the edges in shared memory (a range that holds every
//    bin whose term the dense formula makes non-zero, found with the same
//    float32 comparisons), sums a regular site's normaliser s over that
//    range in bin order (the dense loop adds +0.0 outside it, so s is the
//    dense s), and writes the site's record to shared memory.  Then each
//    warp takes every eighth site and its lanes cover the site's range 32
//    bins at a time (31 for an emp site, whose terms are differences of
//    neighbouring edges' CDF values, passed by a shuffle), adding into the
//    warp's own [4, 185] float32 slice of shared memory.  The eight slices
//    are summed in warp order into the chunk's float32 partial, which each
//    thread adds into float64 registers.  The next chunk's sites are loaded
//    into registers while the warps bin this one, and staged while the
//    slices are summed: two barriers a chunk.  The segment's float64
//    [4, 185] sum is the one write to device memory.
// 2. block_sum_kernel, one thread per block and histogram entry, adds the
//    block's segment sums in order in float64.
//
// No atomics anywhere: a site's terms go through a fixed warp and lane, a
// chunk's slices are summed in a fixed order, and a segment and a block
// sum their parts in list order.  Two launches on one input are bitwise
// equal, and since segments are cut from a block's own chunk list, a stream
// split at block boundaries bins bitwise identically (the property
// parallel/mesh.py relies on).
//
// What bounds it on an H100: bytes, once the zeros are skipped.  A site is
// 20 bytes and touches 17 of the 185 bins on average (11 for a regular
// site, 70 for an emp site on bench.py's generator), about 120 float32
// operations.  Evaluated over all 185 bins, 91% of the terms would be
// exact zeros, and per-chunk partials written to device memory for a
// second pass would add 58% of the input's bytes.  So the work follows the
// overlapped bins, the partials stay on chip until a segment of 8 chunks
// is done, and the columns are read where they lie in the stream, with no
// padding.  What is left is instruction issue, most of it in the warps'
// passes over the sites' bins: a few dozen instructions a regular site, an
// IEEE division a bin among them, with the lanes past the site's range
// idle.  Measured on an H100 SXM at 700 W (chip_smoke.py, phase 8): see
// PERF.md.  Segments of 8 chunks keep 125 blocks at ~5,500 CTAs, about
// eight waves of 5 CTAs an SM (47 registers a thread).
//
// Built without --use_fast_math: p = ov / s and (e - ab) / width stay IEEE
// divisions, as in the dense formula, and the guards at s == 0 and width ==
// 1e-30 depend on them.

#include <cuda_runtime.h>
#include <math.h>

#define BIN_CHUNK 512
#define BIN_SEG 8      // chunks a CTA of the first pass walks
#define BIN_THREADS 256
#define BIN_WARPS (BIN_THREADS / 32)
#define BIN_NBINS 185
#define BIN_EDGES 256    // the 186 edges padded with +inf for the search
#define BIN_HIST (4 * BIN_NBINS)
#define BIN_PER_THREAD ((BIN_HIST + BIN_THREADS - 1) / BIN_THREADS)  // entries of the sum a thread keeps
#define BIN_SITES (BIN_CHUNK / BIN_THREADS)  // sites of a chunk a thread stages
static_assert(BIN_CHUNK % BIN_THREADS == 0, "a chunk's sites split evenly over the threads");
#define BIN_EMP 1024     // meta bit of an emp site; the low 10 bits hold its bin
#define SUM_THREADS 256

// a site's record in shared memory: its bin range and kind
#define REC_LO(r) ((r) & 0xff)
#define REC_HI1(r) (((r) >> 8) & 0xff)  // last bin + 1
#define REC_EMP (1 << 16)
#define REC_BIN2(r) ((r) >> 17)

namespace {

__device__ __forceinline__ float clip01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

// number of edges <= x (le) or < x (!le) in the padded, sorted edges
template <bool le>
__device__ __forceinline__ int edges_below(const float* e, float x) {
  int pos = 0;
#pragma unroll
  for (int step = BIN_EDGES / 2; step > 0; step >>= 1) {
    const float v = e[pos + step - 1];
    if (le ? v <= x : v < x) pos += step;
  }
  return pos;
}

// the emp law's CDF at edge j: the dense formula's cl of bin j and ch of bin j-1
__device__ __forceinline__ float emp_cdf(const float* e, int j, float ab, float width, float age) {
  const float x = e[j];
  return x > age ? clip01((x - ab) / width) : 0.f;
}

// a thread's sites of one chunk, loaded from the stream ahead of their use
struct ChunkSites {
  int n;  // sites in the chunk
  float ab[BIN_SITES], ae[BIN_SITES], ws[BIN_SITES], wn[BIN_SITES];
  int meta[BIN_SITES];
};

__device__ __forceinline__ void load_chunk(ChunkSites& r, int c, const float* __restrict__ fv,
                                           long long n_sites, const int* __restrict__ meta,
                                           const long long* __restrict__ chunk_start,
                                           const int* __restrict__ chunk_n) {
  const long long base = chunk_start[c];
  r.n = chunk_n[c];
#pragma unroll
  for (int u = 0; u < BIN_SITES; ++u) {
    const int j = threadIdx.x + u * BIN_THREADS;
    if (j < r.n) {
      const long long i = base + j;
      r.ab[u] = fv[i];
      r.ae[u] = fv[n_sites + i];
      r.ws[u] = fv[2 * n_sites + i];
      r.wn[u] = fv[3 * n_sites + i];
      r.meta[u] = meta[i];
    }
  }
}

// each thread: its sites' bin ranges, and a regular site's normaliser
__device__ __forceinline__ void stage_chunk(const ChunkSites& r, const float* s_edge, float age,
                                            float4* s_site, int2* s_rec) {
#pragma unroll
  for (int u = 0; u < BIN_SITES; ++u) {
    const int j = threadIdx.x + u * BIN_THREADS;
    if (j >= r.n) break;
    const float ab = r.ab[u], ae = r.ae[u];
    const int m = r.meta[u];
    int lo, hi;
    float norm = 0.f;
    if (m & BIN_EMP) {
      const float width = fmaxf(ae - ab, 1e-30f);
      // The CDF F(j) is 0 up to the first edge above max(age, ab), and 1
      // from the first edge above age with e - ab >= width; bin k's term
      // F(k+1) - F(k) is 0 outside [that first edge - 1, this one - 1],
      // except the last bin's, which adds 1 - F(185).
      lo = min(max(edges_below<true>(s_edge, fmaxf(age, ab)) - 1, 0), BIN_NBINS - 1);
      int pos = 0;
#pragma unroll
      for (int step = BIN_EDGES / 2; step > 0; step >>= 1) {
        const float x = s_edge[pos + step - 1];
        if (!(x > age && x - ab >= width)) pos += step;
      }
      hi = min(pos, BIN_NBINS) - 1;
      s_site[j] = make_float4(ab, width, r.ws[u], r.wn[u]);
    } else {
      // bin k overlaps [a, ae] iff edge k < ae and edge k+1 > a
      const float a = fmaxf(ab, age);
      lo = max(edges_below<true>(s_edge, a) - 1, 0);
      hi = min(edges_below<false>(s_edge, ae) - 1, BIN_NBINS - 1);
      for (int k = lo; k <= hi; ++k) {
        const float ov = fminf(ae, s_edge[k + 1]) - fmaxf(a, s_edge[k]);
        norm += ov > 0.f ? ov : 0.f;
      }
      if (!(norm > 0.f)) hi = lo - 1;  // every p is 0
      s_site[j] = make_float4(a, ae, r.ws[u], r.wn[u]);
    }
    const int rec = lo | ((hi + 1) << 8) |
                    ((m & BIN_EMP) ? REC_EMP | ((m & (BIN_EMP - 1)) << 17) : 0);
    s_rec[j] = make_int2(rec, __float_as_int(norm));
  }
}

__global__ void __launch_bounds__(BIN_THREADS)
seg_hist_kernel(const float* __restrict__ fv,              // [4, n_sites]
                long long n_sites,
                const int* __restrict__ meta,              // [n_sites]
                const long long* __restrict__ chunk_start, // [n_chunks]
                const int* __restrict__ chunk_n,           // [n_chunks]
                const int* __restrict__ block_chunks,      // chunk ids grouped by block
                const int* __restrict__ seg_first,         // [n_segs + 1] into block_chunks
                const float* __restrict__ edges,           // [BIN_NBINS + 1]
                float age,
                double* __restrict__ seg_out) {            // [n_segs, 4, BIN_NBINS]
  __shared__ float s_edge[BIN_EDGES];
  // a site's record: {max(age_begin, age), age_end} of a regular site or
  // {age_begin, width} of an emp site, then w_shared, w_notshared; and
  // {bin range and kind, the normaliser's bits}
  __shared__ float4 s_site[BIN_CHUNK];
  __shared__ int2 s_rec[BIN_CHUNK];
  __shared__ float s_acc[BIN_WARPS][BIN_HIST];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int k = t; k < BIN_EDGES; k += BIN_THREADS)
    s_edge[k] = k <= BIN_NBINS ? edges[k] : INFINITY;
  for (int q = t; q < BIN_WARPS * BIN_HIST; q += BIN_THREADS) (&s_acc[0][0])[q] = 0.f;
  double acc[BIN_PER_THREAD] = {};  // entries t, t + BIN_THREADS, ... of the [4, 185] sum

  // The sites of chunk ci + 1 are loaded while the warps bin chunk ci, and
  // staged while the threads sum chunk ci's slices: two barriers a chunk.
  int ci = seg_first[blockIdx.x];
  const int c1 = seg_first[blockIdx.x + 1];
  ChunkSites next;
  next.n = 0;
  if (ci < c1) load_chunk(next, block_chunks[ci], fv, n_sites, meta, chunk_start, chunk_n);
  __syncthreads();
  stage_chunk(next, s_edge, age, s_site, s_rec);
  for (; ci < c1; ++ci) {
    const int n = next.n;
    if (ci + 1 < c1) load_chunk(next, block_chunks[ci + 1], fv, n_sites, meta, chunk_start, chunk_n);
    __syncthreads();

    // each warp: every BIN_WARPS-th site, its lanes over the site's bins
    float* h_s = s_acc[warp];
    float* h_n = h_s + BIN_NBINS;
    for (int j = warp; j < n; j += BIN_WARPS) {
      const int2 rn = s_rec[j];
      const float4 st = s_site[j];
      const int r = rn.x;
      const int lo = REC_LO(r);
      const int hi1 = REC_HI1(r);
      if (r & REC_EMP) {
        for (int k0 = lo; k0 < hi1; k0 += 31) {
          const int k = k0 + lane;
          const float cl = emp_cdf(s_edge, k, st.x, st.y, age);  // edge k <= 215 < BIN_EDGES
          const float ch = __shfl_down_sync(0xffffffffu, cl, 1);
          if (lane < 31 && k < hi1) {
            float pe = ch - cl;
            if (k == BIN_NBINS - 1) pe += 1.f - ch;  // mass beyond the table
            h_n[k] += pe * st.w;
          }
        }
        if (lane == 0) {
          const int b2 = REC_BIN2(r);
          h_s[2 * BIN_NBINS + b2] += st.z;
          h_s[3 * BIN_NBINS + b2] += st.w;
        }
      } else {
        const float s = __int_as_float(rn.y);
        // most regular sites need one pass: an unrolled loop's set-up costs
        // more than it saves (measured on an H100)
#pragma unroll 1
        for (int k = lo + lane; k < hi1; k += 32) {
          const float ov = fminf(st.y, s_edge[k + 1]) - fmaxf(st.x, s_edge[k]);
          const float p = (ov > 0.f ? ov : 0.f) / s;
          h_s[k] += p * st.z;
          h_n[k] += p * st.w;
        }
      }
      __syncwarp();
    }
    __syncthreads();

    // the chunk's float32 partial: the warps' slices in warp order
#pragma unroll
    for (int u = 0; u < BIN_PER_THREAD; ++u) {
      const int q = t + u * BIN_THREADS;
      if (q < BIN_HIST) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < BIN_WARPS; ++w) {
          v += s_acc[w][q];
          s_acc[w][q] = 0.f;
        }
        acc[u] += (double)v;
      }
    }
    if (ci + 1 < c1) stage_chunk(next, s_edge, age, s_site, s_rec);
  }

  double* out = seg_out + (long long)blockIdx.x * BIN_HIST;
#pragma unroll
  for (int u = 0; u < BIN_PER_THREAD; ++u) {
    const int q = t + u * BIN_THREADS;
    if (q < BIN_HIST) out[q] = acc[u];
  }
}

__global__ void __launch_bounds__(SUM_THREADS)
block_sum_kernel(const double* __restrict__ seg_out,  // [n_segs, 4 * BIN_NBINS]
                 const int* __restrict__ block_seg,   // [num_blocks + 1]
                 int num_blocks,
                 double* __restrict__ out) {          // [num_blocks, 4 * BIN_NBINS]
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= (long long)num_blocks * BIN_HIST) return;
  const int b = (int)(i / BIN_HIST);
  const int q = (int)(i % BIN_HIST);
  double acc = 0.0;
  for (int s = block_seg[b]; s < block_seg[b + 1]; ++s)
    acc += seg_out[(long long)s * BIN_HIST + q];
  out[i] = acc;
}

}  // namespace

extern "C" {

int bin_hist_chunk(void) { return BIN_CHUNK; }

int bin_hist_seg(void) { return BIN_SEG; }

int bin_hist_nbins(void) { return BIN_NBINS; }

const char* bin_hist_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches both passes on `stream`; returns the first CUDA error (0 on
// success).  `seg_out` is scratch of n_segs * 4 * 185 doubles; `out`
// receives [num_blocks, 4, 185] doubles.  Does not synchronise.
int bin_hist_f32(const float* fv, long long n_sites, const int* meta,
                 const long long* chunk_start, const int* chunk_n,
                 const int* block_chunks, const int* seg_first, int n_segs,
                 const int* block_seg, int num_blocks, const float* edges,
                 float age, double* seg_out, double* out, void* stream) {
  if (n_sites < 0 || n_segs < 0 || num_blocks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_segs > 0) {
    seg_hist_kernel<<<n_segs, BIN_THREADS, 0, s>>>(fv, n_sites, meta, chunk_start, chunk_n,
                                                  block_chunks, seg_first, edges, age,
                                                  seg_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (num_blocks > 0) {
    const long long n = (long long)num_blocks * BIN_HIST;
    block_sum_kernel<<<(unsigned)((n + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0, s>>>(
        seg_out, block_seg, num_blocks, out);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // extern "C"
