// The block body of the exact 1-NN sweeps split into work items over
// blocks: nn_matched.cu (kernel 4, the winner's payload read after the
// merge), nn_sweep.cu (kernel 5, no payload) and nn_pairs.cu (kernel 8,
// the payload and a seed-only chunk prune, kPrune) launch it, so all run
// one op sequence.
//
// Grid (query groups, work items, pairs).  A block of nt threads holds Q
// queries a thread, a group of G = nt Q queries (the last group of a pair
// may be ragged: its missing queries are computed on a copy of the last
// one and never written).  A work item is a contiguous, ascending range
// of `item` db chunks of 128 points; the wrappers size it from the shapes
// alone so that a small call still puts several blocks on every SM and a
// large one sweeps few items.  Within an item the sweep is ascending with
// a strict '<' on a (distance, index) carry, so the lowest index of the
// item wins its ties; each db point loaded from shared memory (a 16-byte
// broadcast of four points per coordinate row) feeds Q independent
// distance chains.  The D coordinate rows arrive by cp.async, double
// buffered, one barrier a chunk.
//
// A group of one item writes its result directly.  Otherwise each item
// writes a partial (distance, index) per query, and the last of the
// group's blocks to finish (a ticket per (pair, group), taken after
// __threadfence(), reset by that block) merges them lexicographically on
// (distance, index): the lowest index wins ties whatever order the blocks
// ran in.  With kPayload the payload is not carried through the sweep:
// the merging (or only) block reads the winner's F payload rows from the
// packed db.  A query with no valid db point gets (+inf, 0) and a zero
// payload: sentinel distances overflow to +inf and never win.
//
// With kPrune (kernel 8) a work item walks only the chunks that pass the
// prune test of the queries' subtiles: chunk c is swept for the queries
// of subtile u (q_sub consecutive queries) when lb(u, c) <= bound[u], lb
// the squared distance between the subtile's query box and the chunk's
// box, dims summed in order and deflated by 1 - 16 eps.  Each of a
// thread's Q query slots (nt consecutive queries, inside one subtile: the
// launcher takes q_sub a multiple of kThreads) has one subtile, the same
// for every thread of the block, so each test is block-uniform: a chunk
// that no slot walks is neither staged nor swept, and a slot that does
// not walk a staged chunk sweeps it with +inf query coordinates, whose
// distances are +inf or NaN and never win.  So each query's result is
// the ascending sweep of the chunks its subtile walks, the plain
// version's (ops/nn_pairs_cuda.nn_pairs_plain).
//
// The squared distance is (dx*dx + dy*dy) + dz*dz with every rounding
// explicit (the files built with --fmad=false), the operations of the
// plain version in ops/nn_sweep_cuda.py (its leading 0 + dx*dx is dx*dx
// for every square), so the two agree bitwise.
//
// What bounds it on this card: instruction issue.  Each (query, db point)
// pair costs D sub, D mul, D - 1 add, a compare and two selects (8 in 2D,
// 11 in 3D; no fused multiply-add: bitwise NN forbids it), the index
// shared by the Q queries.  Small calls (3,072 x 3,072) are bound by
// filling the card and by the launch.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace icp_items {

constexpr int kChunk = 128;
constexpr int kThreads = 128;

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
__device__ __forceinline__ void stage(float (*buf)[kChunk], const float* db,
                                      int m_pad, int base) {
  for (int e = threadIdx.x; e < D * (kChunk / 4); e += blockDim.x) {
    const int row = e / (kChunk / 4), col = (e % (kChunk / 4)) * 4;
    cp_async16(&buf[row][col], db + (size_t)row * m_pad + base + col);
  }
  cp_async_commit();
}

__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// Kernel 8's prune inputs: per (pair, subtile) the query box (8 floats:
// lo 0..3, hi 4..7) and the bound, per (pair, chunk) the chunk's box,
// and the subtile's queries.  Unused without kPrune.
struct Prune {
  const float* qbox;
  const float* cbox;
  const float* qbound;
  int q_sub;
};

// Sweep one staged chunk CH (db points CBASE..CBASE + 127) in ascending
// order for the Q queries QV, carrying best/bi: four points per step, one
// 16-byte shared load per coordinate row (a broadcast), then the four in
// ascending order against each query, a strict '<' on the (distance,
// index) carry.  One source for both loops of nn_items_kernel: a macro,
// since kernels 4 and 5's registers depend on the sweep being written
// out in their loop rather than called.
#define NN_ITEMS_SWEEP_CHUNK(CH, CBASE, QV)                                 \
  _Pragma("unroll 2") for (int e = 0; e < kChunk; e += 4) {                \
    float4 cv[D];                                                          \
    _Pragma("unroll") for (int r = 0; r < D; ++r) {                        \
      cv[r] = *reinterpret_cast<const float4*>(&(CH)[r][e]);               \
    }                                                                      \
    _Pragma("unroll") for (int u = 0; u < 4; ++u) {                        \
      const int gi = (CBASE) + e + u;                                      \
      _Pragma("unroll") for (int s = 0; s < Q; ++s) {                      \
        float d = 0.0f;                                                    \
        _Pragma("unroll") for (int r = 0; r < D; ++r) {                    \
          const float p = u == 0 ? cv[r].x                                 \
                          : u == 1 ? cv[r].y                               \
                          : u == 2 ? cv[r].z : cv[r].w;                    \
          const float df = __fsub_rn((QV)[s][r], p);                       \
          d = r == 0 ? __fmul_rn(df, df)                                   \
                     : __fadd_rn(d, __fmul_rn(df, df));                    \
        }                                                                  \
        if (d < best[s]) {                                                 \
          best[s] = d;                                                     \
          bi[s] = gi;                                                      \
        }                                                                  \
      }                                                                    \
    }                                                                      \
  }

// The pruned loop's sweep of one chunk.
template <int D, int Q>
__device__ __forceinline__ void sweep_chunk(const float (*ch)[kChunk],
                                            int cbase,
                                            const float (&qv)[Q][D],
                                            float (&best)[Q], int (&bi)[Q]) {
  NN_ITEMS_SWEEP_CHUNK(ch, cbase, qv)
}

// Kernel 8's test for one subtile and chunk: lb <= bound, lb the squared
// box-to-box distance (dims in order, deflated by 1 - 16 eps), the plain
// version's op sequence.
template <int D>
__device__ __forceinline__ bool chunk_walks(const float* qb, const float* cb,
                                            float bound) {
  constexpr float kDeflate = 1.0f - 16.0f * FLT_EPSILON;
  float lb = 0.0f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float a = __fsub_rn(cb[k], qb[4 + k]);
    const float b = __fsub_rn(qb[k], cb[4 + k]);
    const float gap = fmaxf(fmaxf(a, b), 0.0f);
    lb = __fadd_rn(lb, __fmul_rn(gap, gap));
  }
  return __fmul_rn(lb, kDeflate) <= bound;
}

// query (b, qp, D); dbf_cm (b, D + f_dim, m_pad); outputs dist/idx (b, qp)
// and, with kPayload, pay (b, qp, f_dim).  part and ticket as the
// launchers document them; pr with kPrune.
template <int D, int Q, bool kPayload, bool kPrune = false>
__global__ void __launch_bounds__(kThreads)
nn_items_kernel(const float* __restrict__ query,
                const float* __restrict__ dbf_cm, float* __restrict__ dist,
                int* __restrict__ idx, float* __restrict__ pay, float* part,
                int* ticket, int qp, int f_dim, int m_pad, int item,
                Prune pr) {
  __shared__ __align__(16) float buf[2][D][kChunk];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int g_size = nt * Q;
  const int group = blockIdx.x;
  const int k = blockIdx.y;
  const int pair = blockIdx.z;
  const int n_items = gridDim.y;
  const int q0 = group * g_size;
  const size_t gid = (size_t)pair * gridDim.x + group;
  const float* qpair = query + (size_t)pair * qp * D;
  const float* db = dbf_cm + (size_t)pair * (D + f_dim) * m_pad;

  // Thread tid holds queries q0 + s*nt + tid, s < Q.
  float qv[Q][D];
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const int q = min(q0 + s * nt + tid, qp - 1);
#pragma unroll
    for (int c = 0; c < D; ++c) qv[s][c] = qpair[(size_t)q * D + c];
  }
  float best[Q];
  int bi[Q];
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    best[s] = INFINITY;
    bi[s] = 0;
  }

  const int c0 = k * item;
  const int c1 = min(m_pad / kChunk, c0 + item);
  if constexpr (!kPrune) {
    // Kernels 4 and 5's loop.
    stage<D>(buf[0], db, m_pad, c0 * kChunk);
    for (int c = c0; c < c1; ++c) {
      cp_async_wait_all();
      // Chunk c has landed for every thread, and every thread is done
      // with chunk c - 1, whose buffer chunk c + 1 now takes.
      __syncthreads();
      if (c + 1 < c1) {
        stage<D>(buf[(c + 1 - c0) & 1], db, m_pad, (c + 1) * kChunk);
      }
      const float(*ch)[kChunk] = buf[(c - c0) & 1];
      const int cbase = c * kChunk;
      NN_ITEMS_SWEEP_CHUNK(ch, cbase, qv)
    }
  } else {
    // Slot s's subtile (its queries lie in one), or -1 past qp.
    const int n_sub = qp / pr.q_sub;
    const int n_ch = m_pad / kChunk;
    int sub[Q];
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      const int first = q0 + s * nt;
      sub[s] = first < qp ? pair * n_sub + first / pr.q_sub : -1;
    }
    const float* cb = pr.cbox + (size_t)pair * n_ch * 8;
    // Bit s: slot s walks chunk c (a slot past qp walks every staged
    // chunk: its results are never written).
    auto walks = [&](int c) {
      unsigned w = 0u, any = 0u;
#pragma unroll
      for (int s = 0; s < Q; ++s) {
        const bool ok = sub[s] < 0
                        || chunk_walks<D>(pr.qbox + (size_t)sub[s] * 8,
                                          cb + (size_t)c * 8,
                                          pr.qbound[sub[s]]);
        w |= (unsigned)ok << s;
        any |= (unsigned)(ok && sub[s] >= 0);
      }
      return any ? w : 0u;
    };
    auto next = [&](int c, unsigned& w) {
      for (; c < c1; ++c) {
        w = walks(c);
        if (w) break;
      }
      return c;
    };
    unsigned w = 0u;
    int c = next(c0, w);
    if (c < c1) stage<D>(buf[0], db, m_pad, c * kChunk);
    int slot = 0;
    while (c < c1) {
      unsigned w_next = 0u;
      const int nx = next(c + 1, w_next);
      cp_async_wait_all();
      // Chunk c has landed, and every thread is done with the chunk
      // before it, whose buffer chunk nx now takes.
      __syncthreads();
      if (nx < c1) stage<D>(buf[slot ^ 1], db, m_pad, nx * kChunk);
      float qc[Q][D];
#pragma unroll
      for (int s = 0; s < Q; ++s) {
#pragma unroll
        for (int r = 0; r < D; ++r) {
          qc[s][r] = (w >> s) & 1u ? qv[s][r] : INFINITY;
        }
      }
      sweep_chunk<D, Q>(buf[slot], c * kChunk, qc, best, bi);
      slot ^= 1;
      c = nx;
      w = w_next;
    }
  }

  if (n_items > 1) {
    // Partial of item k: G distances, then G indices.
    float* mine = part + (gid * n_items + k) * 2 * g_size;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      mine[s * nt + tid] = best[s];
      mine[g_size + s * nt + tid] = __int_as_float(bi[s]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&ticket[gid], 1) == n_items - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* gp = part + gid * n_items * 2 * g_size;
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
    if (tid == 0) ticket[gid] = 0;
  }
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const int qi = q0 + s * nt + tid;
    if (qi >= qp) continue;
    const size_t q = (size_t)pair * qp + qi;
    dist[q] = best[s];
    idx[q] = bi[s];
    if (kPayload) {
      const bool hit = best[s] < INFINITY;
      for (int f = 0; f < f_dim; ++f) {
        pay[q * f_dim + f] = hit ? db[(size_t)(D + f) * m_pad + bi[s]] : 0.0f;
      }
    }
  }
}

template <int D, int Q, bool kPayload, bool kPrune = false>
cudaError_t launch(const float* query, const float* dbf_cm, float* dist,
                   int* idx, float* pay, float* part, int* ticket, int b,
                   int qp, int f_dim, int m_pad, int item,
                   cudaStream_t stream, Prune pr = Prune{}) {
  const int n_ch = m_pad / kChunk;
  const dim3 grid((qp + kThreads * Q - 1) / (kThreads * Q),
                  (n_ch + item - 1) / item, b);
  nn_items_kernel<D, Q, kPayload, kPrune><<<grid, kThreads, 0, stream>>>(
      query, dbf_cm, dist, idx, pay, part, ticket, qp, f_dim, m_pad, item,
      pr);
  return cudaGetLastError();
}

// The launchers' dispatch over (D, Q) in {2, 3} x {2, 4, 8}, after their
// own checks: cudaGetLastError(), or cudaErrorInvalidValue for another D
// or Q, a work item of no chunk, m_pad not a multiple of 128 or an empty
// launch.
template <bool kPayload>
int dispatch(const float* query, const float* dbf_cm, float* dist, int* idx,
             float* pay, float* part, int* ticket, int b, int qp, int d_dim,
             int f_dim, int m_pad, int item, int q_per_thread,
             cudaStream_t s) {
  if (item < 1 || m_pad % kChunk != 0 || b < 1 || qp < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define NN_ITEMS_CASE(D, Q)                                                \
  if (d_dim == D && q_per_thread == Q)                                    \
    return static_cast<int>(launch<D, Q, kPayload>(                       \
        query, dbf_cm, dist, idx, pay, part, ticket, b, qp, f_dim, m_pad, \
        item, s));
  NN_ITEMS_CASE(2, 2) NN_ITEMS_CASE(2, 4) NN_ITEMS_CASE(2, 8)
  NN_ITEMS_CASE(3, 2) NN_ITEMS_CASE(3, 4) NN_ITEMS_CASE(3, 8)
#undef NN_ITEMS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace icp_items
