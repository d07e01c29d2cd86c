// nn_pruned: exact 1-NN by a zig-zag sweep with exact per-tile pruning,
// optional payload.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:_nn_pruned_kernel
// (wrapper _nn_pruned_2d, dispatch nn_pallas and nn_pallas_matched), which
// serves single-cloud searches over dbs of 3 tiles or more: unseeded
// (nn_pallas, F = 0) or matched without a seed or with a wide payload.  On
// the SLAM path: the mean post-alignment NN distance of run_slam3d at full
// width (28,160 x 28,160 points, 14 db tiles of 2048, query tiles of 512),
// once per consecutive pair and once per verified loop candidate.
//
// The db tiles of query tile i are visited diagonal first: positions
// 0..n-1 of the order are tiles s..n-1 ascending, then s-1..0 descending,
// s = i q_tile / db_tile.  The order is cut into work items of `item`
// consecutive positions, and each (group of G queries, item) is one
// block: grid (qp / G, ceil(n / item)), sized from shapes alone.  A block
// of nt threads holds Q queries a thread (G = nt Q queries, inside one
// query tile), so every db point it loads from shared memory feeds Q
// independent distance chains.  Within its item the block keeps its own
// threshold, min(max of its queries' current bests, qb_tile[i]), refreshed
// by a block-wide max after each swept tile, and skips a tile whose box
// lies farther from the query tile's box (squared, dims summed in order,
// deflated by 1 - 16 eps) than the threshold; position 0 is always swept.
// An item's best is never below the query's final best, so a skipped tile
// holds no point of any of its queries' tie sets: the result is the
// unpruned sweep's, bit for bit, whatever the items are.
//
// A tile is swept ascending with a strict '<' into a fresh carry (the
// lowest index of the tile wins its ties), which is merged into the
// item's carry lexicographically on (distance, index).  A query group of
// one item writes its result directly; otherwise each item writes a
// partial (distance, index) per query, and the last of the group's blocks
// to finish (a ticket per group, taken after __threadfence(), reset by
// that block) merges them lexicographically: the lowest index wins ties
// whatever order the blocks ran in.  The payload is not carried: the
// merging block reads the winner's F payload rows from the packed db, and
// a query with no valid db point gets (+inf, 0, 0) (sentinel distances
// overflow to +inf and never win).
//
// The squared distance is (dx*dx + dy*dy) + dz*dz with every rounding
// explicit (the file built with --fmad=false), the operations of the
// plain version in ops/nn_sweep_cuda.py, so the two agree bitwise.  The
// db's D coordinate rows arrive 128 points at a time by cp.async, double
// buffered, one barrier a chunk.
//
// What bounds it on this card: instruction issue.  The SLAM path hands it
// unsorted frames, whose tile boxes all overlap, so it sweeps nearly
// every pair: 28,160 x 28,672 at full width, each 3 sub, 3 mul, 2 add, a
// compare and two selects (no fused multiply-add: bitwise NN forbids it).
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kChunk = 128;
constexpr int kMaxThreads = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage the D coordinate rows of db points [base, base + 128), 16 bytes
// per copy.
template <int D>
__device__ __forceinline__ void stage(float (*buf)[kChunk],
                                      const float* dbf_cm, int m_pad,
                                      int base) {
  for (int e = threadIdx.x; e < D * (kChunk / 4); e += blockDim.x) {
    const int row = e / (kChunk / 4), col = (e % (kChunk / 4)) * 4;
    cp_async16(&buf[row][col], dbf_cm + (size_t)row * m_pad + base + col);
  }
  cp_async_commit();
}

__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Max of every thread's value, returned to all threads of the block.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = fmaxf(v, red[w]);
  __syncthreads();
  return v;
}

template <int D, int Q>
__global__ void __launch_bounds__(kMaxThreads)
nn_pruned_kernel(const float* __restrict__ query,
                 const float* __restrict__ dbf_cm,
                 const float* __restrict__ qbox,
                 const float* __restrict__ bbox,
                 const float* __restrict__ qb_tile, float* __restrict__ dist,
                 int* __restrict__ idx, float* __restrict__ pay, float* part,
                 int* ticket, int f_dim, int m_pad, int q_tile, int db_tile,
                 int item) {
  __shared__ __align__(16) float buf[2][D][kChunk];
  __shared__ float red[kMaxThreads / 32];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int g_size = nt * Q;
  const int group = blockIdx.x;
  const int k = blockIdx.y;
  const int n_items = gridDim.y;
  const int n_db = m_pad / db_tile;
  const int q0 = group * g_size;
  const int qt = q0 / q_tile;
  const int start = (int)((long long)qt * q_tile / db_tile);
  const float* qb = qbox + (size_t)qt * 8;
  const float bound = qb_tile[qt];

  // Thread tid holds queries q0 + s*nt + tid, s < Q.
  float qv[Q][D];
#pragma unroll
  for (int s = 0; s < Q; ++s) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      qv[s][c] = query[(size_t)(q0 + s * nt + tid) * D + c];
    }
  }
  float best[Q];
  int bi[Q];
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    best[s] = INFINITY;
    bi[s] = 0;
  }

  constexpr float kDeflate = 1.0f - 16.0f * FLT_EPSILON;
  const int n_ch = db_tile / kChunk;
  float maxd = bound;
  const int j_end = min(n_db, (k + 1) * item);
  for (int j = k * item; j < j_end; ++j) {
    const int tile = j >= n_db - start ? n_db - 1 - j : start + j;
    const float* tb = bbox + (size_t)tile * 8;
    float lb = 0.0f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float a = __fsub_rn(tb[c], qb[4 + c]);
      const float b = __fsub_rn(qb[c], tb[4 + c]);
      const float gap = fmaxf(fmaxf(a, b), 0.0f);
      lb = __fadd_rn(lb, __fmul_rn(gap, gap));
    }
    lb = __fmul_rn(lb, kDeflate);
    // Block-uniform: the branch and its barriers are taken by all.
    if (!(j == 0 || lb <= maxd)) continue;

    float cb[Q];
    int ci[Q];
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      cb[s] = INFINITY;
      ci[s] = INT_MAX;
    }
    // buf is free: the last tile's reads ended before block_max's
    // barriers.
    const int base0 = tile * db_tile;
    stage<D>(buf[0], dbf_cm, m_pad, base0);
    for (int c = 0; c < n_ch; ++c) {
      cp_async_wait_all();
      // Chunk c has landed for every thread, and every thread is done
      // with chunk c - 1, whose buffer chunk c + 1 now takes.
      __syncthreads();
      if (c + 1 < n_ch) {
        stage<D>(buf[(c + 1) & 1], dbf_cm, m_pad, base0 + (c + 1) * kChunk);
      }
      const float(*ch)[kChunk] = buf[c & 1];
      const int cbase = base0 + c * kChunk;
      // Four points per step: one 16-byte shared load per coordinate row
      // (a broadcast), then the four in ascending order against each of
      // the Q queries.
#pragma unroll 2
      for (int e = 0; e < kChunk; e += 4) {
        float4 cv[D];
#pragma unroll
        for (int r = 0; r < D; ++r) {
          cv[r] = *reinterpret_cast<const float4*>(&ch[r][e]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int gi = cbase + e + u;
#pragma unroll
          for (int s = 0; s < Q; ++s) {
            float d = 0.0f;
#pragma unroll
            for (int r = 0; r < D; ++r) {
              const float p = u == 0 ? cv[r].x
                              : u == 1 ? cv[r].y : u == 2 ? cv[r].z : cv[r].w;
              const float df = __fsub_rn(qv[s][r], p);
              // (0 + x) is x for every square x, so the first term
              // starts the sum.
              d = r == 0 ? __fmul_rn(df, df) : __fadd_rn(d, __fmul_rn(df, df));
            }
            if (d < cb[s]) {
              cb[s] = d;
              ci[s] = gi;
            }
          }
        }
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      if (lex_less(cb[s], ci[s], best[s], bi[s])) {
        best[s] = cb[s];
        bi[s] = ci[s];
      }
      m = fmaxf(m, best[s]);
    }
    maxd = fminf(block_max(m, red), bound);
  }

  if (n_items > 1) {
    // Partial of item k: G distances, then G indices.
    float* mine = part + ((size_t)group * n_items + k) * 2 * g_size;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      mine[s * nt + tid] = best[s];
      mine[g_size + s * nt + tid] = __int_as_float(bi[s]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&ticket[group], 1) == n_items - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* gp = part + (size_t)group * n_items * 2 * g_size;
    for (int it = 0; it < n_items; ++it) {
      const float* pk = gp + (size_t)it * 2 * g_size;
#pragma unroll
      for (int s = 0; s < Q; ++s) {
        const float d = __ldcg(pk + s * nt + tid);
        const int i = __float_as_int(__ldcg(pk + g_size + s * nt + tid));
        if (lex_less(d, i, best[s], bi[s])) {
          best[s] = d;
          bi[s] = i;
        }
      }
    }
    if (tid == 0) ticket[group] = 0;
  }
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const size_t q = (size_t)q0 + s * nt + tid;
    dist[q] = best[s];
    idx[q] = bi[s];
    const bool hit = best[s] < INFINITY;
    for (int f = 0; f < f_dim; ++f) {
      pay[q * f_dim + f] =
          hit ? dbf_cm[(size_t)(D + f) * m_pad + bi[s]] : 0.0f;
    }
  }
}

template <int D, int Q>
cudaError_t launch(const float* query, const float* dbf_cm, const float* qbox,
                   const float* bbox, const float* qb_tile, float* dist,
                   int* idx, float* pay, float* part, int* ticket, int qp,
                   int q_tile, int db_tile, int f_dim, int m_pad, int item,
                   int threads, cudaStream_t stream) {
  const int n_db = m_pad / db_tile;
  const dim3 grid(qp / (threads * Q), (n_db + item - 1) / item);
  nn_pruned_kernel<D, Q><<<grid, threads, 0, stream>>>(
      query, dbf_cm, qbox, bbox, qb_tile, dist, idx, pay, part, ticket,
      f_dim, m_pad, q_tile, db_tile, item);
  return cudaGetLastError();
}

}  // namespace

// query (qp, d_dim); dbf_cm (d_dim + f_dim, m_pad), 16-byte aligned; qbox
// (qp / q_tile, 8); bbox (m_pad / db_tile, 8); qb_tile (qp / q_tile,);
// outputs dist/idx (qp,) and pay (qp, f_dim) (unused when f_dim is 0).
// Blocks of `threads` threads (32, 64 or 128) with q_per_thread queries
// each (2, 4 or 8), threads * q_per_thread dividing q_tile; work items of
// `item` tiles.  part: scratch of qp * ceil((m_pad / db_tile) / item) * 2
// floats; ticket: qp / (threads * q_per_thread) ints, zero on entry and
// left zero.  Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// unsupported (d_dim, f_dim) or block shape.
extern "C" int nn_pruned_launch(const float* query, const float* dbf_cm,
                                const float* qbox, const float* bbox,
                                const float* qb_tile, float* dist, int* idx,
                                float* pay, float* part, int* ticket, int qp,
                                int q_tile, int db_tile, int d_dim, int f_dim,
                                int m_pad, int item, int threads,
                                int q_per_thread, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // What the callers pass (ops/nn_sweep_cuda.py PRUNED_INSTANCES).
  const bool served = (d_dim == 2 && (f_dim == 0 || f_dim == 2))
                      || (d_dim == 3 && f_dim >= 0 && f_dim <= 4
                          && f_dim != 1);
  if (!served || item < 1 || db_tile % kChunk != 0
      || (threads != 32 && threads != 64 && threads != 128)
      || q_tile % (threads * q_per_thread) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define NN_PRUNED_CASE(D, Q)                                                 \
  if (d_dim == D && q_per_thread == Q)                                      \
    return static_cast<int>(launch<D, Q>(query, dbf_cm, qbox, bbox, qb_tile, \
                                         dist, idx, pay, part, ticket, qp,  \
                                         q_tile, db_tile, f_dim, m_pad,     \
                                         item, threads, s));
  NN_PRUNED_CASE(2, 2) NN_PRUNED_CASE(2, 4) NN_PRUNED_CASE(2, 8)
  NN_PRUNED_CASE(3, 2) NN_PRUNED_CASE(3, 4) NN_PRUNED_CASE(3, 8)
#undef NN_PRUNED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
