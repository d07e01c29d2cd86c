// nn_list: survivor-list exact 1-NN with matched payload.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:_nn_list_kernel
// (wrappers _nn_list_2d, _nn_seeded_2d).
//
// Each query tile of q_tile queries walks the 128-point db chunks of its
// survivor list (all n_chunks chunks when cnt > cap) in ascending order.
// The walk is cut into work items of `item` consecutive entries, and each
// item is one block: grid (n_tiles, ceil(max(n_chunks, cap) / item)),
// one thread per query.  Block (tile, j) sweeps entries [j*item,
// (j+1)*item) of its tile's walk; a block past its tile's walk exits at
// once, so the grid is sized from shapes alone and the host never reads
// cnt.  A tile of one item writes its result directly.  Otherwise each
// item writes a partial (dist, idx, payload) per query to scratch, and
// the last of the tile's blocks to finish (a ticket per tile, taken
// after __threadfence(), reset by that block) merges the partials in
// item order with the same strict '<'.  Items are ascending entry
// ranges, so the merge reproduces the single ascending sweep exactly:
// the lowest index wins ties, whatever order the blocks ran in.  With
// no valid point the result is (+inf, 0, 0).
//
// Each block double-buffers its chunks in shared memory: the (D + F) x
// 128 floats of entry w + 1 arrive by cp.async while entry w is swept,
// one barrier per chunk.
//
// The squared distance is ((0 + dx*dx) + dy*dy) + dz*dz with every
// rounding explicit (and the file built with --fmad=false), the same
// operations as the plain version in ops/nn_cuda.py, so the two agree
// bitwise.
//
// What bounds it on this card: the card-wide walk against the longest
// item.  A warm 28,800-point call walks ~1,300-1,500 (tile, chunk)
// sweeps of 256 x 128 pairs, 10 operations each.  One tile's list can
// hold ~60 chunks, and up to every chunk (240 on the main path, 512 at
// the submap's 65,536-row view); cut into items of at most `item`
// chunks, the sweeps spread over all 132 SMs, several blocks resident on
// each (3-8 KB of shared memory, 256 threads), and no block walks more
// than `item` chunks.  Blocks past their tile's walk cost a launch slot
// and one load.  Bytes stay small (a walked chunk is 2.5-3.5 KB from
// L2).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 128;

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

// Stage chunk ch's D + F rows of 128 floats, 16 bytes per copy.
template <int D, int F>
__device__ __forceinline__ void stage(float (*buf)[kChunk],
                                      const float* dbf_cm, int m_pad,
                                      int ch) {
  for (int e = threadIdx.x; e < (D + F) * (kChunk / 4); e += blockDim.x) {
    const int row = e / (kChunk / 4), col = (e % (kChunk / 4)) * 4;
    cp_async16(&buf[row][col],
               dbf_cm + (size_t)row * m_pad + (size_t)ch * kChunk + col);
  }
  cp_async_commit();
}

template <int D, int F>
__global__ void nn_list_kernel(const float* __restrict__ query,
                               const float* __restrict__ dbf_cm,
                               const int* __restrict__ lists,
                               const int* __restrict__ cnt,
                               float* __restrict__ dist,
                               int* __restrict__ idx,
                               float* __restrict__ pay, float* part,
                               int* ticket, int m_pad, int n_chunks,
                               int cap, int item) {
  constexpr int FF = F > 0 ? F : 1;
  __shared__ __align__(16) float buf[2][D + F][kChunk];
  __shared__ int last;
  const int tile = blockIdx.x;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int q_tile = blockDim.x;
  const int c = cnt[tile];
  const bool full = c > cap;
  const int walk = full ? n_chunks : c;
  const int n_items = (walk + item - 1) / item;
  // Block 0 of a tile with an empty walk writes its (+inf, 0, 0).
  if (j >= (n_items > 0 ? n_items : 1)) return;

  const int q = tile * q_tile + tid;
  float qv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) qv[k] = query[q * D + k];
  float best = INFINITY;
  int bi = 0;
  float bp[FF];
#pragma unroll
  for (int f = 0; f < FF; ++f) bp[f] = 0.0f;

  const int begin = j * item;
  const int end = min(walk, begin + item);
  const int* row = lists + (size_t)tile * cap;
  if (begin < end) {
    stage<D, F>(buf[0], dbf_cm, m_pad, full ? begin : row[begin]);
  }
  for (int w = begin; w < end; ++w) {
    const int ch = full ? w : row[w];
    cp_async_wait_all();
    // Entry w has landed for every thread, and every thread is done with
    // entry w - 1, whose buffer entry w + 1 now takes.
    __syncthreads();
    if (w + 1 < end) {
      stage<D, F>(buf[(w + 1 - begin) & 1], dbf_cm, m_pad,
                  full ? w + 1 : row[w + 1]);
    }
    const float(*chunk)[kChunk] = buf[(w - begin) & 1];
    // Four points per step: one 16-byte shared load per coordinate row
    // (a broadcast: every thread reads the same points), then the four
    // in ascending order.
    for (int e = 0; e < kChunk; e += 4) {
      float4 cv[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        cv[k] = *reinterpret_cast<const float4*>(&chunk[k][e]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float d = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float c = u == 0 ? cv[k].x
                          : u == 1 ? cv[k].y : u == 2 ? cv[k].z : cv[k].w;
          const float df = __fsub_rn(qv[k], c);
          d = __fadd_rn(d, __fmul_rn(df, df));
        }
        if (d < best) {
          best = d;
          bi = ch * kChunk + e + u;
#pragma unroll
          for (int f = 0; f < F; ++f) bp[f] = chunk[D + f][e + u];
        }
      }
    }
  }

  if (n_items > 1) {
    // Partial of item j: rows dist, idx, payload of q_tile floats each.
    const int stride = 2 + F;
    float* mine = part + ((size_t)tile * gridDim.y + j) * stride * q_tile;
    mine[tid] = best;
    mine[q_tile + tid] = __int_as_float(bi);
#pragma unroll
    for (int f = 0; f < F; ++f) mine[(2 + f) * q_tile + tid] = bp[f];
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&ticket[tile], 1) == n_items - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    best = INFINITY;
    bi = 0;
#pragma unroll
    for (int f = 0; f < FF; ++f) bp[f] = 0.0f;
    const float* tp = part + (size_t)tile * gridDim.y * stride * q_tile;
    for (int k = 0; k < n_items; ++k) {
      const float* pk = tp + (size_t)k * stride * q_tile;
      const float d = __ldcg(pk + tid);
      if (d < best) {
        best = d;
        bi = __float_as_int(__ldcg(pk + q_tile + tid));
#pragma unroll
        for (int f = 0; f < F; ++f) {
          bp[f] = __ldcg(pk + (2 + f) * q_tile + tid);
        }
      }
    }
    if (tid == 0) ticket[tile] = 0;
  }
  dist[q] = best;
  idx[q] = bi;
#pragma unroll
  for (int f = 0; f < F; ++f) pay[(size_t)q * F + f] = bp[f];
}

template <int D, int F>
cudaError_t launch(const float* query, const float* dbf_cm, const int* lists,
                   const int* cnt, float* dist, int* idx, float* pay,
                   float* part, int* ticket, int n_tiles, int q_tile,
                   int m_pad, int cap, int item, cudaStream_t stream) {
  const int n_chunks = m_pad / kChunk;
  const int most = n_chunks > cap ? n_chunks : cap;
  const dim3 grid(n_tiles, (most + item - 1) / item);
  nn_list_kernel<D, F><<<grid, q_tile, 0, stream>>>(
      query, dbf_cm, lists, cnt, dist, idx, pay, part, ticket, m_pad,
      n_chunks, cap, item);
  return cudaGetLastError();
}

}  // namespace

// query (n_tiles*q_tile, d_dim) row-major; dbf_cm (d_dim + f_dim, m_pad),
// 16-byte aligned; lists (n_tiles, cap); cnt (n_tiles,); outputs dist/idx
// (n_tiles*q_tile,) and pay (n_tiles*q_tile, f_dim).  part: scratch of
// n_tiles * ceil(max(m_pad/128, cap) / item) * (2 + f_dim) * q_tile
// floats; ticket: n_tiles ints, zero on entry and left zero.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported
// (d_dim, f_dim) or item < 1.
extern "C" int nn_list_launch(const float* query, const float* dbf_cm,
                              const int* lists, const int* cnt, float* dist,
                              int* idx, float* pay, float* part, int* ticket,
                              int n_tiles, int q_tile, int d_dim, int f_dim,
                              int m_pad, int cap, int item, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (item < 1) return static_cast<int>(cudaErrorInvalidValue);
#define NN_LIST_CASE(D, F)                                                  \
  if (d_dim == D && f_dim == F)                                             \
    return static_cast<int>(launch<D, F>(query, dbf_cm, lists, cnt, dist,   \
                                         idx, pay, part, ticket, n_tiles,   \
                                         q_tile, m_pad, cap, item, s));
  NN_LIST_CASE(2, 0) NN_LIST_CASE(2, 1) NN_LIST_CASE(2, 2)
  NN_LIST_CASE(2, 3) NN_LIST_CASE(2, 4) NN_LIST_CASE(2, 5)
  NN_LIST_CASE(2, 6)
  NN_LIST_CASE(3, 0) NN_LIST_CASE(3, 1) NN_LIST_CASE(3, 2)
  NN_LIST_CASE(3, 3) NN_LIST_CASE(3, 4) NN_LIST_CASE(3, 5)
#undef NN_LIST_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
