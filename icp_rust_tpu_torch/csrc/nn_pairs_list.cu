// nn_pairs_list: pair-grid survivor-list exact 1-NN with matched payload,
// each (pair, subtile) walk split into work items over blocks.
//
// Replaces the TPU kernel icp_rust_tpu/ops/nn_pallas.py:
// _nn_pairs_list_kernel (wrapper _nn_pairs_list_impl, dispatch
// nn_pallas_matched_pairs), which serves every warm outer iteration of
// batched ICP.
//
// Each (pair, subtile of q_sub queries) walks the 128-point db chunks of
// its survivor list, built in torch (ops/nn_pairs_cuda._survivor_lists:
// the prune test per 64-query group, unioned per subtile, ascending ids;
// the list capacity cap holds every chunk, so no list overflows).  The
// walk is cut into work items of `item` consecutive list entries, one
// block each: grid (B * n_subtiles, ceil(cap / item)), blocks of
// q_sub / Q threads holding Q queries each (queries s * threads + tid,
// s < Q).  Block (row, j) sweeps entries [j * item, (j + 1) * item) of its
// row's list; a block past its row's walk exits at once, so the grid is
// sized from shapes alone and the host never reads cnt.  A row of one
// item writes its result directly.  Otherwise each item writes a partial
// (distance, index) per query, and the last of the row's blocks to finish
// (a ticket per row, taken after __threadfence(), reset by that block)
// merges them lexicographically on (distance, index).  Within an item the
// sweep is ascending with a strict '<', so the result is the ascending
// sweep's: the lowest index wins ties, whatever order the blocks ran in.
// The payload is not carried through the sweep: the block that writes the
// result reads the winner's F payload rows from the packed db.  With no
// valid point walked the result is (+inf, 0, 0).
//
// Given the queries' bounds and the chunk boxes (qbound, cbox), each slot
// s of a warp, 32 consecutive queries, repeats the list's prune test for
// its own group: the box of its 32 queries against the chunk's box
// (dimensions summed in order, deflated by 1 - 16 eps) against the
// largest of their bounds; a group that fails it skips the chunk.  The
// test is warp-uniform, made once a chunk, and exact for the same reason
// as the lists (a skipped chunk holds no point of the group's tie sets);
// the plain version makes the same test.  On the batched path it leaves
// ~0.7 of the lists' (query, point) pairs.
//
// The chunks (and their boxes) arrive by cp.async, double buffered, one
// barrier a chunk; each db point loaded from shared memory (a 16-byte
// broadcast of four points per coordinate row) feeds Q independent
// distance chains.  The squared distance is (dx*dx + dy*dy) + dz*dz with
// every rounding explicit (the file built with --fmad=false), the
// operations of the plain version in ops/nn_pairs_cuda.py, so the two
// agree bitwise.
//
// What bounds it on this card: instruction issue over the swept (query,
// point) pairs, 8 instructions each in 2D (D sub, D mul, D - 1 add, a
// compare, two selects; bitwise NN may not fuse), and at the path's
// small calls the launch and the chain of dependent loads, the sweep and
// the merge (~10 us at a few dozen pairs).  The batched warm call walks
// ~2,400 (subtile, chunk) sweeps of 256 x 128 pairs; a block per (pair,
// subtile) walking its whole list would put at most 627 blocks on the
// card and let the longest list set the launch.  Work items of few
// entries spread those sweeps over every SM, several blocks resident on
// each (2-3 KB of shared memory, q_sub / Q threads), no block walks more
// than `item` chunks, and the group test cuts the pairs swept.  Blocks
// past their row's walk cost a launch slot and one load.
#include "nn_items.cuh"

namespace {

using icp_items::kChunk;
using icp_items::lex_less;

constexpr float kDeflate = 1.0f - 16.0f * FLT_EPSILON;
constexpr unsigned kFull = 0xffffffffu;

// Stage entry ch's D coordinate rows of 128 floats and, when the group
// test is on (cbox), its chunk box (8 floats), 16 bytes per copy.
template <int D>
__device__ __forceinline__ void stage(float (*rows)[kChunk], float* box,
                                      const float* db, const float* cbox,
                                      int m_pad, int ch) {
  for (int e = threadIdx.x; e < D * (kChunk / 4); e += blockDim.x) {
    const int r = e / (kChunk / 4), col = (e % (kChunk / 4)) * 4;
    icp_items::cp_async16(&rows[r][col],
                          db + (size_t)r * m_pad + (size_t)ch * kChunk + col);
  }
  if (cbox != nullptr && threadIdx.x < 2) {
    icp_items::cp_async16(box + 4 * threadIdx.x,
                          cbox + (size_t)ch * 8 + 4 * threadIdx.x);
  }
  icp_items::cp_async_commit();
}

// Sweep one staged chunk in ascending order against NS queries: one
// 16-byte shared load per coordinate row (a broadcast) feeds the NS
// distance chains of four points.
template <int D, int NS>
__device__ __forceinline__ void sweep_chunk(const float (*ch)[kChunk],
                                            int cbase,
                                            const float (&qv)[NS][D],
                                            float (&best)[NS],
                                            int (&bi)[NS]) {
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
      for (int s = 0; s < NS; ++s) {
        float d = 0.0f;
#pragma unroll
        for (int r = 0; r < D; ++r) {
          const float p = u == 0 ? cv[r].x
                          : u == 1 ? cv[r].y : u == 2 ? cv[r].z : cv[r].w;
          const float df = __fsub_rn(qv[s][r], p);
          d = r == 0 ? __fmul_rn(df, df) : __fadd_rn(d, __fmul_rn(df, df));
        }
        if (d < best[s]) {
          best[s] = d;
          bi[s] = gi;
        }
      }
    }
  }
}

template <int D, int Q>
__global__ void __launch_bounds__(1024)
nn_pairs_list_kernel(const float* __restrict__ query,
                     const float* __restrict__ dbf_cm,
                     const int* __restrict__ lists,
                     const int* __restrict__ cnt,
                     const float* __restrict__ qbound,
                     const float* __restrict__ cbox,
                     float* __restrict__ dist, int* __restrict__ idx,
                     float* __restrict__ pay, float* part, int* ticket,
                     int qp, int f_dim, int m_pad, int cap, int item) {
  __shared__ __align__(16) float buf[2][D][kChunk];
  __shared__ __align__(16) float boxes[2][8];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int q_sub = nt * Q;
  const int n_qt = qp / q_sub;
  const int row = blockIdx.x;
  const int j = blockIdx.y;
  const int walk = cnt[row];
  const int n_items = (walk + item - 1) / item;
  // Block 0 of a row with an empty walk writes its (+inf, 0, 0).
  if (j >= (n_items > 0 ? n_items : 1)) return;

  const int pair = row / n_qt;
  const int nc = m_pad / kChunk;
  const size_t q0 = (size_t)pair * qp + (size_t)(row % n_qt) * q_sub;
  const float* db = dbf_cm + (size_t)pair * (D + f_dim) * m_pad;
  const float* cb = cbox != nullptr ? cbox + (size_t)pair * nc * 8 : nullptr;
  float qv[Q][D];
#pragma unroll
  for (int s = 0; s < Q; ++s) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      qv[s][c] = query[(q0 + s * nt + tid) * D + c];
    }
  }
  // The group test: slot s of a warp holds 32 consecutive queries, one
  // group; its box and its bound (the largest of its queries' bounds).
  float glo[Q][D], ghi[Q][D], gbound[Q];
  if (cb != nullptr) {
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      gbound[s] = qbound[q0 + s * nt + tid];
#pragma unroll
      for (int c = 0; c < D; ++c) glo[s][c] = ghi[s][c] = qv[s][c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        gbound[s] = fmaxf(gbound[s], __shfl_xor_sync(kFull, gbound[s], o));
#pragma unroll
        for (int c = 0; c < D; ++c) {
          glo[s][c] = fminf(glo[s][c], __shfl_xor_sync(kFull, glo[s][c], o));
          ghi[s][c] = fmaxf(ghi[s][c], __shfl_xor_sync(kFull, ghi[s][c], o));
        }
      }
    }
  }
  float best[Q];
  int bi[Q];
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    best[s] = INFINITY;
    bi[s] = 0;
  }

  const int begin = j * item;
  const int end = min(walk, begin + item);
  const int* ent = lists + (size_t)row * cap;
  if (begin < end) stage<D>(buf[0], boxes[0], db, cb, m_pad, ent[begin]);
  for (int w = begin; w < end; ++w) {
    const int cbase = ent[w] * kChunk;
    icp_items::cp_async_wait_all();
    // Entry w has landed for every thread, and every thread is done with
    // entry w - 1, whose buffers entry w + 1 now takes.
    __syncthreads();
    if (w + 1 < end) {
      stage<D>(buf[(w + 1 - begin) & 1], boxes[(w + 1 - begin) & 1], db, cb,
               m_pad, ent[w + 1]);
    }
    const float(*ch)[kChunk] = buf[(w - begin) & 1];
    if (cb == nullptr) {
      sweep_chunk<D, Q>(ch, cbase, qv, best, bi);
      continue;
    }
    // A group sweeps the chunk only if the box-to-box lower bound
    // (dimensions summed in order, deflated by 1 - 16 eps) does not
    // exceed its bound: the test of ops/nn_pairs_cuda._box_lower_bound,
    // uniform over each warp.
    const float* bx = boxes[(w - begin) & 1];
    bool act[Q];
    bool all = true;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      float lb = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float a = __fsub_rn(bx[c], ghi[s][c]);
        const float b = __fsub_rn(glo[s][c], bx[4 + c]);
        const float gap = fmaxf(fmaxf(a, b), 0.0f);
        lb = __fadd_rn(lb, __fmul_rn(gap, gap));
      }
      act[s] = __fmul_rn(lb, kDeflate) <= gbound[s];
      all = all && act[s];
    }
    if (all) {
      sweep_chunk<D, Q>(ch, cbase, qv, best, bi);
      continue;
    }
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      if (!act[s]) continue;
      float q1[1][D], b1[1] = {best[s]};
      int i1[1] = {bi[s]};
#pragma unroll
      for (int c = 0; c < D; ++c) q1[0][c] = qv[s][c];
      sweep_chunk<D, 1>(ch, cbase, q1, b1, i1);
      best[s] = b1[0];
      bi[s] = i1[0];
    }
  }

  if (n_items > 1) {
    // Partial of item j: q_sub distances, then q_sub indices.
    float* mine = part + ((size_t)row * gridDim.y + j) * 2 * q_sub;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      mine[s * nt + tid] = best[s];
      mine[q_sub + s * nt + tid] = __int_as_float(bi[s]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&ticket[row], 1) == n_items - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* rp = part + (size_t)row * gridDim.y * 2 * q_sub;
    for (int k = 0; k < n_items; ++k) {
      const float* pk = rp + (size_t)k * 2 * q_sub;
#pragma unroll
      for (int s = 0; s < Q; ++s) {
        const float d = __ldcg(pk + s * nt + tid);
        const int i = __float_as_int(__ldcg(pk + q_sub + s * nt + tid));
        if (lex_less(d, i, best[s], bi[s])) {
          best[s] = d;
          bi[s] = i;
        }
      }
    }
    if (tid == 0) ticket[row] = 0;
  }
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const size_t q = q0 + s * nt + tid;
    dist[q] = best[s];
    idx[q] = bi[s];
    const bool hit = best[s] < INFINITY;
    for (int f = 0; f < f_dim; ++f) {
      pay[q * f_dim + f] = hit ? db[(size_t)(D + f) * m_pad + bi[s]] : 0.0f;
    }
  }
}

template <int D, int Q>
cudaError_t launch(const float* query, const float* dbf_cm, const int* lists,
                   const int* cnt, const float* qbound, const float* cbox,
                   float* dist, int* idx, float* pay, float* part,
                   int* ticket, int b, int qp, int q_sub, int f_dim,
                   int m_pad, int cap, int item, cudaStream_t stream) {
  const dim3 grid(b * (qp / q_sub), (cap + item - 1) / item);
  nn_pairs_list_kernel<D, Q><<<grid, q_sub / Q, 0, stream>>>(
      query, dbf_cm, lists, cnt, qbound, cbox, dist, idx, pay, part, ticket,
      qp, f_dim, m_pad, cap, item);
  return cudaGetLastError();
}

}  // namespace

// query (B, qp, d_dim); dbf_cm (B, d_dim + f_dim, m_pad), m_pad a multiple
// of 128, 16-byte aligned; lists (B, qp / q_sub, cap); cnt
// (B, qp / q_sub); outputs dist/idx (B, qp) and pay (B, qp, f_dim), f_dim
// 2, 3 or 4 (4: the point-to-plane payload [n, c = n . q], whose sentinel
// c on invalid rows is copied as it is).
// Blocks of q_sub / q_per_thread threads (q_per_thread 1, 2 or 4; a
// multiple of 32, at most 1024); work items of `item` list entries.
// part: scratch of B * (qp / q_sub) * ceil(cap / item) * 2 * q_sub
// floats; ticket: B * (qp / q_sub) ints, zero on entry and left zero.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an unsupported
// (d_dim, f_dim) or schedule.
extern "C" int nn_pairs_list_launch(const float* query, const float* dbf_cm,
                                    const int* lists, const int* cnt,
                                    const float* qbound, const float* cbox,
                                    float* dist, int* idx, float* pay,
                                    float* part, int* ticket, int b, int qp,
                                    int q_sub, int d_dim, int f_dim,
                                    int m_pad, int cap, int item,
                                    int q_per_thread, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_per_thread < 1 || q_sub < 1 || q_sub % q_per_thread != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = q_sub / q_per_thread;
  if (f_dim < 2 || f_dim > 4 || item < 1 || cap < 1 || b < 1
      || m_pad % icp_items::kChunk != 0 || threads % 32 != 0
      || threads > 1024 || qp % q_sub != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define NN_PAIRS_LIST_CASE(D, Q)                                            \
  if (d_dim == D && q_per_thread == Q)                                      \
    return static_cast<int>(launch<D, Q>(query, dbf_cm, lists, cnt, qbound, \
                                         cbox, dist, idx, pay, part,        \
                                         ticket, b, qp, q_sub, f_dim,       \
                                         m_pad, cap, item, s));
  NN_PAIRS_LIST_CASE(2, 1) NN_PAIRS_LIST_CASE(2, 2) NN_PAIRS_LIST_CASE(2, 4)
  NN_PAIRS_LIST_CASE(3, 1) NN_PAIRS_LIST_CASE(3, 2) NN_PAIRS_LIST_CASE(3, 4)
#undef NN_PAIRS_LIST_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
