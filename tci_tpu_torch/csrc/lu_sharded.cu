// One rank's pivot step of the row-sharded complete-pivot rank-revealing LU.
//
// Replaces the per-device body of tci_tpu/ops/lu_sharded.py::_make_state_fn
// (the XLA while loop that rrlu_sharded_raw and make_lu_split_sharded run
// inside shard_map). The panel's rows are cut into P contiguous blocks, one
// per rank of a torch.distributed group; every rank holds its block and a
// replicated copy of the permutations and of the elimination's scalars.
// One pivot step is one launch of step_kernel and one all-gather of the
// ranks' slots, on one stream, with no read by the host
// (tci_tpu_torch/ops/lu_sharded.py):
//
//   decision  every block reads the P gathered slots (each rank's candidate:
//             |a|^2, key = swapped column position << 32 | swapped row
//             position, the entry, its row and column, and the candidate's
//             whole row) and the replicated state (k, the stop flag, the row
//             and column at position k), none of which depends on another
//             load, and takes the same decision: the largest |a|^2, NaN
//             above every value, then the smallest key, the global first
//             maximum in the swapped column-major order, which is the
//             reference's two-stage rule (the column with the largest
//             maximum, then the first row in it); then the stop test of
//             matrixlu.jl:363. Each block applies the virtual swaps in its
//             registers where they touch its rows and columns; no block
//             writes replicated state that another block may still read;
//   prologue  the block's rows: which are live, the pending x's, and this
//             step's x from the pivot column as it stands (the column goes
//             to the buffer as it ends); each column chunk's keys, y from
//             the winner's slot row (divided by the pivot once a column
//             when right-orthogonal) and the pending y's, in shared memory;
//   pass      a warp a row, 16-byte loads and stores, four vectors a lane
//             in flight: each live entry rebuilt from the buffer by the
//             pending updates a - x_t y_t in their order, then this step's
//             update, and in the same pass each lane's next candidate; the
//             owner stores row pr as it ends. The write-back is deferred
//             over `depth` steps (1 while the block fits the L2, kMaxDefer
//             above, ops/lu_sharded.defer_depth): a pass stores
//             the block only when the pending updates reach the depth, at
//             the last pivot (maxrank), and when the elimination stops with
//             updates pending (the flush); the other passes only read it.
//             The rebuild is the same rounded steps in the same order, so
//             the result does not depend on the depth;
//   last      each block leaves its candidate in the scratch and counts
//             itself on one counter (__threadfence, atomicAdd). The last
//             block reduces the G candidates, writes the rank's candidate
//             and its row as it stands (rebuilt where this pass stored
//             nothing) into the send slot, writes the replicated state of
//             the next step (the swaps, the magnitudes, k, err, the stop
//             flag, the row and column at k + 1) and resets the counter, so
//             a CUDA graph of steps replays.
//
// The first launch of an elimination (First) is the pass alone: the rank's
// first candidate over its valid block.
//
// Every element is computed with lu_common.cuh's intrinsics (no FMA
// contraction), in rrlu.cu's formulas, so each rank rounds exactly as the
// one-device kernel and the plain PyTorch version do: the pivot order, the
// pivot count, err and the factored buffer are bitwise theirs. The slots
// travel as integers; the collectives never see a float.
//
// Bound. The guide's rule counts each input byte read once: at config 2
// (4096^2 f64, 256 pivots) 2 sum_j (m - 1 - j)(n - 1 - j) operations over
// 34 TFLOP/s f64, 0.2371 ms. No elimination that keeps the block in device
// memory comes near it: reading and writing the rank's live block,
// (m_blk - j)(n - j) elements at step j, once a step is 19.2628 ms over
// 3.35 TB/s at config 2; with the write deferred over 4 steps a step reads
// the block and writes a quarter of it, ~12.0 ms. The design works to that
// floor: one launch a step (no pick or swap kernel, no column maxima), the
// update and the candidate search in one pass, a write every depth-th
// step, and a decision that waits on one round of loads.

#include <algorithm>

#include "lu_common.cuh"

namespace {

// the replicated integer state (ist): k, the stop flag, and the row and the
// column at position k (rowperm[k], colperm[k]: what the swap of step k
// moves, read with k, so the decision waits for no load after another);
// the real state (rst)
enum { kK = 0, kDone = 1, kRowAtK = 2, kColAtK = 3 };
enum { kMaxErr = 0, kErr = 1 };

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2;
constexpr int kUnroll = 4;  // vectors a lane loads before it stores
// A slot's header: |a|^2 at byte 0, the key at 8, the entry at 16, the
// candidate's row and column (original indices, int32) at 32 and 36; the
// row starts at 48.
constexpr int kHead = 48;
// rows of a block at most (their keys and x live in shared memory)
constexpr int kMaxRows = 256;
// the largest deferral depth: pending updates a pass may rebuild, besides
// its own
constexpr int kMaxDefer = 4;
// shared memory of a block's column chunk: y, the pending y's and the
// column keys (two blocks an SM leave room for each other)
constexpr int kStageBytes = 96 * 1024;
constexpr unsigned long long kNoKey64 = ~0ull;

// V elements of a row, loaded and stored as one (16 bytes where V > 1).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};

struct Step {
  void* A;                // this rank's (m_blk, np) block, row-major
  const long long* recv;  // (P, W) the gathered slots
  long long* send;        // (W,) this rank's slot
  int* rowperm;           // (mp,) position -> row, replicated
  int* rowpos;            // (mp,) row -> position
  int* colperm;           // (np,)
  int* colpos;            // (np,)
  int* ist;               // k, done, rowperm[k], colperm[k]
  void* rst;              // the largest pivot so far, err
  void* mags;             // (min(mp, np),) pivot magnitudes
  void* px;               // (depth, m_blk) the pending updates' x
  void* py;               // (depth, np) and y
  unsigned char* scratch;  // the blocks' candidates and the counter
  int P, W, m_blk, np, mp, offset, m, n, leftorth, maxrank, depth;
  double reltol, abstol;
  int G, rpb, Cw;  // blocks, rows a block, columns a chunk
};

__host__ __device__ inline size_t round256(size_t b) {
  return (b + 255) & ~(size_t)255;
}

// The scratch: the counter, then each block's candidate (|a|^2, key,
// entry, original row and column).
template <typename T>
struct Scratch {
  unsigned* counter;
  typename Ops<T>::R* val;
  unsigned long long* key;
  T* entry;
  int2* at;
};

template <typename T>
__host__ __device__ size_t scratch_layout(unsigned char* base, int G,
                                          Scratch<T>* s) {
  using R = typename Ops<T>::R;
  const size_t o_val = 256;
  const size_t o_key = o_val + round256((size_t)G * sizeof(R));
  const size_t o_ent = o_key + round256((size_t)G * 8);
  const size_t o_at = o_ent + round256((size_t)G * sizeof(T));
  if (s) {
    s->counter = reinterpret_cast<unsigned*>(base);
    s->val = reinterpret_cast<R*>(base + o_val);
    s->key = reinterpret_cast<unsigned long long*>(base + o_key);
    s->entry = reinterpret_cast<T*>(base + o_ent);
    s->at = reinterpret_cast<int2*>(base + o_at);
  }
  return o_at + round256((size_t)G * sizeof(int2));
}

// The step's decision, the same in every block. k1 is the first live
// position after it (k + 1; 0 in the first launch); pc, pr, r_at_k and
// c_at_k are -1 where there is no pivot, so no row or column matches them.
template <typename T>
struct Decision {
  int stop, k, k1, pc, pr, brp, bcp, r_at_k, c_at_k, q;
  typename Ops<T>::R e;
  T safe;
};

template <typename T, bool First>
__device__ void decide(const Step& s, Decision<T>& d) {
  using R = typename Ops<T>::R;
  d.stop = 0;
  d.pc = d.pr = d.r_at_k = d.c_at_k = d.q = -1;
  d.brp = d.bcp = -1;
  d.safe = Ops<T>::one();
  d.e = R(0);
  if (First) {
    d.k = -1;
    d.k1 = 0;
    return;
  }
  const int4 st = *reinterpret_cast<const int4*>(s.ist);
  const int k = st.x;
  d.k = k;
  d.k1 = k + 1;
  R v = R(-1);
  unsigned long long key = kNoKey64;
  T piv = Ops<T>::zero();
  int2 rc = make_int2(-1, -1);
  for (int p = 0; p < s.P; ++p) {
    const long long* slot = s.recv + (size_t)p * s.W;
    const R pv = *reinterpret_cast<const R*>(slot);
    const unsigned long long pk = (unsigned long long)slot[1];
    if (ranks_above(pv, pk, v, key)) {
      v = pv;
      key = pk;
      piv = *reinterpret_cast<const T*>(slot + 2);
      rc = *reinterpret_cast<const int2*>(slot + 4);
      d.q = p;
    }
  }
  if (v < R(0)) {  // no valid line left: stop with err 0
    d.stop = 1;
    return;
  }
  // v >= 0 or NaN, so sqrt(max(v, 0)) is sqrt(v)
  const R e = Ops<R>::sqrt(v);
  const R maxerror = static_cast<const R*>(s.rst)[kMaxErr];
  d.e = e;
  d.stop = k > 0 && (e < Ops<R>::mul(R(s.reltol), maxerror) ||
                     e < R(s.abstol) || e == R(0));
  if (d.stop) return;
  d.bcp = (int)(key >> 32);
  d.brp = (int)(unsigned)key;
  d.pr = rc.x;
  d.pc = rc.y;
  d.r_at_k = st.z;
  d.c_at_k = st.w;
  d.safe = Ops<T>::nonzero(piv) ? piv : Ops<T>::one();
}

// The candidates of a warp reduced: every lane ends with the winner and
// the entry and place its holder names.
template <typename T>
__device__ __forceinline__ void warp_best(typename Ops<T>::R& v,
                                          unsigned long long& key, T& ent,
                                          int2& at) {
  const unsigned long long mine = key;
  warp_argmax(v, key);
  const int holder = __ffs(__ballot_sync(0xffffffffu, mine == key)) - 1;
  ent = shfl_from(ent, holder);
  at.x = __shfl_sync(0xffffffffu, at.x, holder);
  at.y = __shfl_sync(0xffffffffu, at.y, holder);
}

// The block's candidates reduced through shared memory; thread 0 ends with
// the winner.
template <typename T>
__device__ void block_best(typename Ops<T>::R& v, unsigned long long& key,
                           T& ent, int2& at, typename Ops<T>::R* w_val,
                           unsigned long long* w_key, T* w_ent, int2* w_at) {
  using R = typename Ops<T>::R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(v, key, ent, at);
  if (lane == 0) {
    w_val[warp] = v;
    w_key[warp] = key;
    w_ent[warp] = ent;
    w_at[warp] = at;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? w_val[lane] : R(-1);
    key = lane < kWarps ? w_key[lane] : kNoKey64;
    ent = lane < kWarps ? w_ent[lane] : Ops<T>::zero();
    at = lane < kWarps ? w_at[lane] : make_int2(-1, -1);
    warp_best(v, key, ent, at);
  }
}

// |a|^2 into a slot's header: a NaN as the all-ones NaN, the bits torch's
// max gives (the plain version's), so the two agree bitwise.
__device__ __forceinline__ void put_val(long long* slot, float v) {
  *reinterpret_cast<int*>(slot) = v != v ? -1 : __float_as_int(v);
}
__device__ __forceinline__ void put_val(long long* slot, double v) {
  *slot = v != v ? -1ll : __double_as_longlong(v);
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// Dynamic shared memory of a block with NP pending updates: a column
// chunk's y, the pending y's and keys (Cw each), then its rows' x, the
// pending x's and keys (kMaxRows each).
__host__ __device__ inline size_t smem_bytes(int Cw, int es, int NP) {
  return align16((size_t)Cw * es * (1 + NP)) + align16((size_t)Cw * 4) +
         align16((size_t)kMaxRows * es * (1 + NP)) + (size_t)kMaxRows * 4;
}

// Columns of a chunk: as many as kStageBytes holds, a multiple of a warp's
// vectors.
__host__ __device__ inline int chunk_cap(int es, int NP, int V) {
  return kStageBytes / (es * (1 + NP) + 4) / (32 * V) * (32 * V);
}

// One launch: the first candidate (First), or a step with NP updates
// pending in the buffer (the host's count: the steps so far modulo the
// depth). A step with a pivot updates the live block; a step that stops
// with updates pending writes them back (the flush); the pass writes the
// block back when the pending updates reach the depth, at the last pivot
// (maxrank) and in the flush, and otherwise stores nothing.
template <typename T, int V, bool First, int NP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    step_kernel(Step s) {
  using R = typename Ops<T>::R;
  using Vt = Vec<T, V>;
  constexpr int es = (int)sizeof(T);
  // chunk columns a thread loads before it stages them
  constexpr int SU = NP > 0 ? 4 : 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Decision<T> d;
  __shared__ R w_val[kWarps];
  __shared__ unsigned long long w_key[kWarps];
  __shared__ T w_ent[kWarps];
  __shared__ int2 w_at[kWarps];
  __shared__ int s_last, s_row;

  // the flag is written only by a last block, after every block of its
  // launch has read it: every block of this launch reads the same value
  if (s.ist[kDone]) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool lo = s.leftorth != 0;
  T* A = static_cast<T*>(s.A);
  T* px = static_cast<T*>(s.px);
  T* py = static_cast<T*>(s.py);
  Scratch<T> sc;
  scratch_layout<T>(s.scratch, s.G, &sc);
  if (tid == 0) decide<T, First>(s, d);
  __syncthreads();
  const bool upd = !First && !d.stop;  // a pivot this step
  const bool write = !First && (d.stop || NP + 1 >= s.depth ||
                                d.k1 == s.maxrank);
  // the live block after this launch: rows and columns at positions >= thr
  const int thr = First ? 0 : (upd ? d.k1 : d.k);

  R bv = R(-1);
  unsigned long long bkey = kNoKey64;
  T bent = Ops<T>::zero();
  int2 bat = make_int2(-1, -1);
  if (First || upd || NP > 0) {
    const int k = d.k, pc = d.pc, pr = d.pr;
    const int r_lo = blockIdx.x * s.rpb;
    const int nr = max(0, min(s.m_blk, r_lo + s.rpb) - r_lo);
    T* s_y = reinterpret_cast<T*>(smem);
    T* s_py = s_y + s.Cw;  // (NP, Cw)
    int* s_ck = reinterpret_cast<int*>(
        smem + align16((size_t)s.Cw * es * (1 + NP)));
    T* s_x = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(s_ck) +
                                  align16((size_t)s.Cw * 4));
    T* s_px = s_x + kMaxRows;  // (NP, kMaxRows)
    int* s_rk = reinterpret_cast<int*>(
        reinterpret_cast<unsigned char*>(s_x) +
        align16((size_t)kMaxRows * es * (1 + NP)));
    const T* wrow = upd ? reinterpret_cast<const T*>(
                              s.recv + (size_t)d.q * s.W + kHead / 8)
                        : nullptr;
    const T safe = d.safe;
    // The block's rows: the key of a live row (its swapped position), -2
    // for row pr, whose owner stores it as it ends, -1 for the others; the
    // pending x's, and this step's x from the pivot column as it stands
    // (rebuilt from the buffer). The column goes to the buffer as it ends
    // (the left multipliers, or the entries), read here before any lane
    // touches its vector.
    for (int lr = tid; lr < nr; lr += kThreads) {
      const int li = r_lo + lr, gid = s.offset + li;
      int rk = -1;
      T x = Ops<T>::zero();
      if (gid < s.m) {
        const int rpos =
            gid == pr ? k : (gid == d.r_at_k ? d.brp : s.rowpos[gid]);
        if (rpos >= (upd ? k : thr)) {
          T pend[NP > 0 ? NP : 1];
#pragma unroll
          for (int t = 0; t < NP; ++t) {
            pend[t] = px[(size_t)t * s.m_blk + li];
            s_px[t * kMaxRows + lr] = pend[t];
          }
          rk = rpos;
          if (upd) {
            T a = A[(size_t)li * s.np + pc];
#pragma unroll
            for (int t = 0; t < NP; ++t)
              a = Ops<T>::sub(a, Ops<T>::mul(pend[t],
                                             py[(size_t)t * s.np + pc]));
            const bool live = rpos >= thr;
            x = lo ? Ops<T>::div(a, safe) : a;
            A[(size_t)li * s.np + pc] = lo && live ? x : a;
            if (!live) {
              rk = gid == pr ? -2 : -1;
              x = Ops<T>::zero();
            }
          }
        }
      }
      s_rk[lr] = rk;
      s_x[lr] = x;
      if (upd && s.depth > 1) px[(size_t)NP * s.m_blk + li] = x;
    }
    const int nvend = (s.n + V - 1) / V * V;  // columns the vectors cover
    for (int c0 = 0; c0 < s.n; c0 += s.Cw) {
      const int cw = min(s.Cw, nvend - c0);
      if (c0 > 0) __syncthreads();  // the last chunk's readers are done
      // the chunk's column keys (the swapped position of a live column,
      // else -1), y and the pending y's, every load in flight first
      for (int j0 = tid; j0 < cw; j0 += SU * kThreads) {
        int cp[SU];
        T w[SU];
        T pw[NP > 0 ? NP : 1][SU];
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int j = c0 + j0 + u * kThreads;
          const bool in = j0 + u * kThreads < cw && j < s.n;
          cp[u] = in ? s.colpos[j] : -1;
          w[u] = upd && in ? wrow[j] : Ops<T>::zero();
#pragma unroll
          for (int t = 0; t < NP; ++t)
            pw[t][u] = in ? py[(size_t)t * s.np + j] : Ops<T>::zero();
        }
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int jj = j0 + u * kThreads, j = c0 + jj;
          if (jj >= cw) break;
          int cpos = -1;
          if (j < s.n) {
            cpos = j == pc ? k : (j == d.c_at_k ? d.bcp : cp[u]);
            if (cpos < thr) cpos = -1;
          }
          s_ck[jj] = cpos;
          const T y = upd && cpos >= 0
                          ? (lo ? w[u] : Ops<T>::div(w[u], safe))
                          : Ops<T>::zero();
          s_y[jj] = y;
          if (upd && s.depth > 1 && blockIdx.x == 0)
            py[(size_t)NP * s.np + j] = y;
#pragma unroll
          for (int t = 0; t < NP; ++t) s_py[t * s.Cw + jj] = pw[t][u];
        }
      }
      __syncthreads();
      const int nv = cw / V;
      for (int lr = warp; lr < nr; lr += kWarps) {
        const int rk = s_rk[lr];
        if (rk == -1) continue;
        const int li = r_lo + lr;
        T* row = A + (size_t)li * s.np + c0;
        if (rk == -2) {  // the owner stores row pr as it ends
          for (int jj = lane; jj < cw; jj += 32)
            if (s_ck[jj] >= 0) row[jj] = s_y[jj];
          continue;
        }
        const T x = s_x[lr];
        T pend[NP > 0 ? NP : 1];
#pragma unroll
        for (int t = 0; t < NP; ++t) pend[t] = s_px[t * kMaxRows + lr];
        const int gid = s.offset + li;
        const unsigned long long rkey = (unsigned)rk;
        Vt* rv = reinterpret_cast<Vt*>(row);
        for (int t0 = lane; t0 < nv; t0 += 32 * kUnroll) {
          Vt a[kUnroll];
          bool touch[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int t = t0 + 32 * u;
            touch[u] = false;
            if (t < nv) {
#pragma unroll
              for (int e = 0; e < V; ++e) touch[u] |= s_ck[t * V + e] >= 0;
              if (touch[u]) a[u] = rv[t];
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (!touch[u]) continue;
            const int t = t0 + 32 * u;
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const int jj = t * V + e;
              const int ck = s_ck[jj];
              if (ck < 0) continue;
              T v = a[u].e[e];
#pragma unroll
              for (int q = 0; q < NP; ++q)
                v = Ops<T>::sub(v, Ops<T>::mul(pend[q], s_py[q * s.Cw + jj]));
              if (upd) v = Ops<T>::sub(v, Ops<T>::mul(x, s_y[jj]));
              a[u].e[e] = v;
              const R sq = Ops<T>::abs2(v);
              const unsigned long long key =
                  ((unsigned long long)ck << 32) | rkey;
              if (ranks_above(sq, key, bv, bkey)) {
                bv = sq;
                bkey = key;
                bent = v;
                bat = make_int2(gid, c0 + jj);
              }
            }
            if (write) rv[t] = a[u];
          }
        }
      }
    }
  }

  // the block's candidate to the scratch, then the count of blocks done
  block_best<T>(bv, bkey, bent, bat, w_val, w_key, w_ent, w_at);
  if (tid == 0) {
    sc.val[blockIdx.x] = bv;
    sc.key[blockIdx.x] = bkey;
    sc.entry[blockIdx.x] = bent;
    sc.at[blockIdx.x] = bat;
  }
  __threadfence();  // this thread's stores (the pass, the candidate) first
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(sc.counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The last block: every other block has passed its count, so its pass
  // and its reads of the replicated state are done.
  bv = R(-1);
  bkey = kNoKey64;
  bent = Ops<T>::zero();
  bat = make_int2(-1, -1);
  for (int b = tid; b < (int)gridDim.x; b += kThreads) {
    const R v = __ldcg(sc.val + b);
    const unsigned long long key = __ldcg(sc.key + b);
    if (ranks_above(v, key, bv, bkey)) {
      bv = v;
      bkey = key;
      bent = __ldcg(sc.entry + b);
      bat = __ldcg(sc.at + b);
    }
  }
  __syncthreads();  // the warp slots are reused
  block_best<T>(bv, bkey, bent, bat, w_val, w_key, w_ent, w_at);
  if (tid == 0) {
    *sc.counter = 0;  // the next launch, or a graph's replay, counts anew
    if (!d.stop) {
      put_val(s.send, bv);
      s.send[1] = (long long)bkey;
      *reinterpret_cast<T*>(s.send + 2) = bent;
      *reinterpret_cast<int2*>(s.send + 4) = bat;
    }
    s_row = d.stop ? -1 : bat.x;
  }
  __syncthreads();
  if (s_row >= 0) {
    // the candidate's row as it stands into the slot: the buffer's, where
    // this launch did not write it back rebuilt by the pending updates
    // (this step's the last) on its live columns
    const int li = s_row - s.offset;
    const Vt* src = reinterpret_cast<const Vt*>(A + (size_t)li * s.np);
    Vt* dst = reinterpret_cast<Vt*>(s.send + kHead / 8);
    const int nvec = s.np / V;
    T pend[NP + 1];
    if (!write && upd)
#pragma unroll
      for (int t = 0; t <= NP; ++t)
        pend[t] = __ldcg(px + (size_t)t * s.m_blk + li);
    for (int t0 = tid; t0 < nvec; t0 += kUnroll * kThreads) {
      Vt v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (t0 + u * kThreads < nvec)
#pragma unroll
          for (int e = 0; e < V; ++e)
            v[u].e[e] = __ldcg(&src[t0 + u * kThreads].e[e]);
      if (!write && upd) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t0 + u * kThreads >= nvec) continue;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int j = (t0 + u * kThreads) * V + e;
            if (j >= s.n) continue;
            const int cpos =
                j == d.pc ? d.k : (j == d.c_at_k ? d.bcp : s.colpos[j]);
            if (cpos < thr) continue;
            T a = v[u].e[e];
#pragma unroll
            for (int t = 0; t <= NP; ++t)
              a = Ops<T>::sub(
                  a, Ops<T>::mul(pend[t], __ldcg(py + (size_t)t * s.np + j)));
            v[u].e[e] = a;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (t0 + u * kThreads < nvec) dst[t0 + u * kThreads] = v[u];
    }
  }
  __syncthreads();  // the rebuild read the column positions
  if (tid == 0 && !First) {
    R* rst = static_cast<R*>(s.rst);
    if (d.stop) {
      rst[kErr] = d.e;
      s.ist[kDone] = 1;
    } else {
      const int k = d.k;
      s.rowperm[d.brp] = d.r_at_k;
      s.rowperm[k] = d.pr;
      s.rowpos[d.r_at_k] = d.brp;
      s.rowpos[d.pr] = k;
      s.colperm[d.bcp] = d.c_at_k;
      s.colperm[k] = d.pc;
      s.colpos[d.c_at_k] = d.bcp;
      s.colpos[d.pc] = k;
      static_cast<R*>(s.mags)[k] = d.e;
      rst[kMaxErr] = nan_max(rst[kMaxErr], d.e);
      rst[kErr] = d.e;
      s.ist[kK] = k + 1;
    }
  } else if (tid == 32 && upd) {
    // the row and the column at position k + 1 after this step's swap
    // (thread 0 writes positions brp and k of the permutations, neither of
    // which this reads)
    const int k1 = d.k1;
    s.ist[kRowAtK] =
        k1 < s.mp ? (d.brp == k1 ? d.r_at_k : s.rowperm[k1]) : 0;
    s.ist[kColAtK] =
        k1 < s.np ? (d.bcp == k1 ? d.c_at_k : s.colperm[k1]) : 0;
  }
}

// Blocks of a step on a block of m_blk rows: a warp a row, at most
// kBlocksPerSM blocks an SM, unless a block would then hold more than
// kMaxRows rows.
int grid_blocks(int m_blk, int sms) {
  const int want = (m_blk + kWarps - 1) / kWarps;
  const int least = (m_blk + kMaxRows - 1) / kMaxRows;
  return std::max({1, least, std::min(want, sms * kBlocksPerSM)});
}

template <typename T, int V, bool First, int NP>
int launch_one(const Step& s, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      step_kernel<T, V, First, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(chunk_cap((int)sizeof(T), NP, V), (int)sizeof(T), NP));
  if (attr != cudaSuccess) return (int)attr;
  step_kernel<T, V, First, NP>
      <<<s.G, kThreads, smem_bytes(s.Cw, (int)sizeof(T), NP), stream>>>(s);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_v(int phase, int npend, const Step& s, cudaStream_t stream) {
  static_assert(kMaxDefer == 4, "launch_v instantiates NP = 0 ... 3");
  if (phase == 0) return launch_one<T, V, true, 0>(s, stream);
  switch (npend) {
    case 0: return launch_one<T, V, false, 0>(s, stream);
    case 1: return launch_one<T, V, false, 1>(s, stream);
    case 2: return launch_one<T, V, false, 2>(s, stream);
    default: return launch_one<T, V, false, 3>(s, stream);
  }
}

template <typename T>
int launch(int phase, int npend, Step s, int sms, cudaStream_t stream) {
  constexpr int es = (int)sizeof(T);
  constexpr int VV = 16 / es;
  s.G = grid_blocks(s.m_blk, sms);
  s.rpb = (s.m_blk + s.G - 1) / s.G;
  // 16-byte vectors where every row starts on a 16-byte boundary
  const bool vec = VV > 1 && ((uintptr_t)s.A & 15) == 0 &&
                   ((size_t)s.np * es) % 16 == 0;
  const int V = vec ? VV : 1;
  const int nvend = (std::max(s.n, 1) + V - 1) / V * V;
  s.Cw = std::min(chunk_cap(es, phase == 0 ? 0 : npend, V), nvend);
  return vec ? launch_v<T, VV>(phase, npend, s, stream)
             : launch_v<T, 1>(phase, npend, s, stream);
}

}  // namespace

extern "C" {

// Bytes of the scratch a step of an m_blk-row block takes on a card of
// `sms` SMs (zeroed once by the caller: the counter starts at 0).
size_t lu_sharded_scratch_bytes(int dtype, int m_blk, int sms) {
  const int G = grid_blocks(m_blk, sms);
  switch (dtype) {
    case 0: return scratch_layout<float>(nullptr, G, nullptr);
    case 1: return scratch_layout<double>(nullptr, G, nullptr);
    default: return scratch_layout<double2>(nullptr, G, nullptr);
  }
}

// One launch of phase 0 (the first candidate) or 1 (a pivot step with
// npend updates pending) on `stream`, for elements of type 0 float32, 1
// float64, 2 complex128. Returns the CUDA error of the launch (0 on
// success).
int lu_sharded_launch(int dtype, int phase, void* A, void* recv, void* send,
                      void* rowperm, void* rowpos, void* colperm,
                      void* colpos, void* ist, void* rst, void* mags,
                      void* px, void* py, void* scratch, int P, int W,
                      int m_blk, int np, int mp, int offset, int m, int n,
                      int leftorth, int maxrank, int depth, int npend,
                      double reltol, double abstol, int sms, void* stream) {
  Step s{A, (const long long*)recv, (long long*)send, (int*)rowperm,
         (int*)rowpos, (int*)colperm, (int*)colpos, (int*)ist, rst, mags,
         px, py, (unsigned char*)scratch, P, W, m_blk, np, mp, offset, m, n,
         leftorth, maxrank, depth, reltol, abstol, 0, 0, 0};
  const cudaStream_t st = (cudaStream_t)stream;
  if (phase < 0 || phase > 1 || depth < 1 || depth > kMaxDefer ||
      npend < 0 || npend >= depth)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(phase, npend, s, sms, st);
    case 1: return launch<double>(phase, npend, s, sms, st);
    case 2: return launch<double2>(phase, npend, s, sms, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
