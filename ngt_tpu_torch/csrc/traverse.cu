// The sq8 block traversal of graph_search, hand-written for Hopper: each
// query runs its own steps to done inside one launch.
//
// Replaces no Pallas kernel.  The JAX package's traversal is the
// lax.while_loop of ngt_tpu/graph/search.py:369, whose body XLA fuses on
// the TPU; the port ran that body as ~50 small PyTorch kernels a step
// (graph/search.py::_step), replayed eight steps a CUDA graph.  A step cost
// 0.27-0.45 ms whatever share of its rows was live, so launches and the
// kernels' fixed costs set it, not the data it reads.
//
// What bounds it: the dependent memory round trips of a step.  A step
// selects the best unexpanded pool entry (pool, on chip), reads that node's
// adjacency row and block row (device memory), then the valid byte and the
// visited word of each neighbour (device memory, addressed by the ids just
// read), and merges.  That is two round trips of device-memory latency
// (~0.6-1 us each) a step, against about 9.4 KB a SIFT query-step (48 x
// 128 B of int8 codes, 48 x 4 B of ids, 48 valid and visited words in
// their 32 B sectors): at 3.35 TB/s a 512-query step of live rows moves in
// under 2 us, so bytes never bound it, the chain of latencies does.
//
// The design, per query (one warp each, up to MAX_WARPS queries a block):
//  - The pool (distances, ids, expanded flags, width w) lives in shared
//    memory for the whole launch and is written back once; the query (f32)
//    too, laid out so that each lane reads its own 16 components without
//    bank conflicts.  Nothing of a step goes to device memory except the
//    visited word of the expanded node.
//  - The visited table stays in the caller's [B, 2^hash_bits / 32] int32
//    buffer; only the owning warp touches a query's words, so there are
//    no atomics on it.  The bits of the node expanded in this step are
//    or-ed into the loaded words in registers, so the step never waits for
//    its own store.
//  - As soon as the node is chosen, the warp issues its whole block row
//    (e x M bytes, contiguous) as 16-byte cp.async copies into shared
//    memory and its adjacency row into registers; the valid and visited
//    loads of the neighbours follow as soon as the ids arrive, and the
//    distances are computed while those are in flight.  So a step costs
//    two round trips plus the arithmetic.
//  - Scoring: eight lanes score one neighbour's row (16 codes a lane per
//    16-byte vector, codes turned into floats exactly with a byte permute
//    and one subtraction), summed over the eight lanes by shuffles.  The
//    elementwise L2 form sqrt(sum (q - x)^2) in f32, as
//    ops/distances.py::gathered computes it, and for rows of 128 R codes
//    in the order of PyTorch's own CUDA sum, so the distances, and with
//    them every admission and every count, equal the step loop's.
//  - The merge keeps (d, id) order (ops/select.py::lex_key) with the pool
//    first on equal keys: the pool's live entries are compacted (they are
//    already sorted), each entry's rank in the merged order is counted
//    (a binary search over the pool for a new entry, a scan over the few
//    admitted neighbours for both), and the first w ranks are written.
//  - A query that is done, or reaches max_iters, leaves the loop; its
//    warp writes the pool and counts back and raises the launch's step
//    count to its own (atomicMax), so no done check runs between steps.
//
// Each step reproduces graph/search.py::_step for p = 1 exactly (with
// another PyTorch reduction order the ids would agree on >= 99.9% of
// entries, the sums differing in their last bits).  Offsets
// into the block rows and the visited table are 64-bit (block tensors pass
// 2^31 elements at 1M rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// most edges a row the kernel reads (register arrays of EV_MAX ids a lane)
constexpr int EV_MAX = 8;
constexpr int E_MAX = 32 * EV_MAX;
constexpr int MAX_WARPS = 4;
constexpr int SMEM_LIMIT = 227 * 1024;

struct Params {
  const uint8_t* x;       // block rows: row r holds e_max x m codes
  long long x_row;        // bytes from one block row to the next
  const int32_t* nbr;     // adjacency, nbr_row ids from one row to the next
  long long nbr_row;
  const uint8_t* valid;   // [>= n] bool
  const float* q;         // [b, m]
  const float* radius0;   // [b]
  float* pool_d;          // [b, w]
  int32_t* pool_i;        // [b, w]
  uint8_t* pool_e;        // [b, w] bool
  int32_t* visited;       // [b, words]
  long long words;
  uint8_t* done;          // [b] bool
  int32_t* vc;            // [b]
  int32_t* dc;            // [b]
  int32_t* own;           // [b]
  unsigned long long* steps;
  int b, n, e, m, w, k, kr, hash_bits, exact, max_iters;
  float eps;
};

// Shared memory of one warp, in bytes, and the offsets of its parts.
struct Layout {
  int qs, pi, ck, ak, row, pd, nds, slo, okj, pe, ce, bytes;
};

__host__ __device__ inline int round_up(int v, int a) { return (v + a - 1) / a * a; }

__host__ __device__ inline Layout layout(int w, int e, int m) {
  Layout L;
  const int w4 = round_up(w, 4);
  const int v = (m / 16 + 7) / 8;   // 16-byte vectors a lane holds of a row
  L.qs = 0;                          // the query, v x 32 float4
  L.pi = L.qs + v * 512;             // pool ids, w4 (int4 scans)
  L.ck = L.pi + 4 * w4;              // the pool's live keys, compacted
  L.ak = L.ck + 8 * w;               // the admitted neighbours' keys
  L.row = round_up(L.ak + 8 * e, 16);  // the expanded node's block row
  L.pd = L.row + e * m;              // pool distances
  L.nds = L.pd + 4 * w4;             // the neighbours' distances
  L.slo = L.nds + 4 * e;             // pool entries <= each admitted key, sorted
  L.okj = L.slo + 4 * e;             // the live neighbours' edge positions
  L.pe = L.okj + 4 * e;              // pool expanded flags
  L.ce = L.pe + w4;                  // the compacted entries' flags
  L.bytes = round_up(L.ce + w4, 16);
  return L;
}

// ops/select.py::lex_key: the float's order-preserving int32 in the high
// half, the id + 2^31 in the low half.
__device__ __forceinline__ long long lex_key(float d, int id) {
  int bits = __float_as_int(d);
  bits ^= (bits >> 31) & 0x7fffffff;
  return (long long)((unsigned long long)(long long)bits << 32) + ((long long)id + 2147483648LL);
}

__device__ __forceinline__ float key_d(long long key) {
  int hi = (int)(key >> 32);
  return __int_as_float(hi ^ ((hi >> 31) & 0x7fffffff));
}

__device__ __forceinline__ int key_id(long long key) {
  return (int)((unsigned)key ^ 0x80000000u);
}

// graph/search.py::_hash_slots for an id >= 0: the word and its two bits
// (equal in the exact table).
__device__ __forceinline__ void slot(int id, int hash_bits, int exact, long long& word,
                                     unsigned& m1, unsigned& m2) {
  if (exact) {
    word = id >> 5;
    m1 = m2 = 1u << (id & 31);
    return;
  }
  const unsigned u = (unsigned)id;
  const unsigned h1 = (u * 2654435761u) >> (32 - hash_bits);
  const unsigned b1 = h1 & 31u;
  const unsigned h2 = (u * 2246822519u) >> 27;
  const unsigned b2 = (b1 + 1u + h2 % 31u) & 31u;
  word = (long long)(h1 >> 5);
  m1 = 1u << b1;
  m2 = 1u << b2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four codes of a word as exact floats: 0x4B0000xx is 2^23 + xx; int8
// codes are biased by 128 first.
template <bool SIGNED>
__device__ __forceinline__ float code(unsigned word, unsigned sel) {
  const float magic = SIGNED ? 8388736.0f : 8388608.0f;
  return __int_as_float(__byte_perm(word, 0x4B000000u, sel)) - magic;
}

// The squared differences of the 16 codes of v to the query's components
// qc, added into acc[k][i] (code 4k + i); the products rounded on their
// own, as PyTorch's elementwise product before its sum.
template <bool SIGNED, bool FIRST>
__device__ __forceinline__ void squares(uint4 v, const float4 (&qc)[4], float (&acc)[4][4]) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned u = SIGNED ? (words[k] ^ 0x80808080u) : words[k];
    const float4 qq = qc[k];
    const float d[4] = {qq.x - code<SIGNED>(u, 0x7440), qq.y - code<SIGNED>(u, 0x7441),
                        qq.z - code<SIGNED>(u, 0x7442), qq.w - code<SIGNED>(u, 0x7443)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sq = __fmul_rn(d[i], d[i]);
      acc[k][i] = FIRST ? sq : __fadd_rn(acc[k][i], sq);
    }
  }
}

template <bool SIGNED>
__global__ void __launch_bounds__(MAX_WARPS * 32) traverse_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * (blockDim.x >> 5) + warp;
  if (qi >= p.b || p.done[qi]) return;   // a done query changes nothing

  const int w = p.w, e = p.e, m = p.m;
  const Layout L = layout(w, e, m);
  unsigned char* base = smem + (size_t)warp * L.bytes;
  float4* qs = reinterpret_cast<float4*>(base + L.qs);
  int* pi = reinterpret_cast<int*>(base + L.pi);
  long long* ck = reinterpret_cast<long long*>(base + L.ck);
  long long* ak = reinterpret_cast<long long*>(base + L.ak);
  unsigned char* row = base + L.row;
  float* pd = reinterpret_cast<float*>(base + L.pd);
  float* nds = reinterpret_cast<float*>(base + L.nds);
  int* slo = reinterpret_cast<int*>(base + L.slo);
  int* okj = reinterpret_cast<int*>(base + L.okj);
  unsigned char* pe = base + L.pe;
  unsigned char* ce = base + L.ce;

  const float inf = __int_as_float(0x7f800000);
  const int w4 = round_up(w, 4);
  const int G = m >> 4;             // 16-byte vectors of a neighbour's codes
  const int V = (G + 7) >> 3;       // of them, a lane's
  const int g = lane >> 3, s = lane & 7;
  const long long qoff = (long long)qi * w;
  const unsigned lt = (1u << lane) - 1u;
  const int ev = (e + 31) >> 5;

  // ---- the query's pool and vector into shared memory: the vector as
  // qs[(t * 4 + k) * 8 + s] = components [(s + 8t) * 16 + 4k, +4), so lane
  // s of each group of eight reads its own without bank conflicts
  for (int j = lane; j < w4; j += 32) {
    const bool in = j < w;
    pd[j] = in ? p.pool_d[qoff + j] : inf;
    pi[j] = in ? p.pool_i[qoff + j] : -1;
    pe[j] = in ? p.pool_e[qoff + j] : 0;
  }
  {
    const float4* q4 = reinterpret_cast<const float4*>(p.q + (long long)qi * m);
    for (int j = lane; j < V * 32; j += 32) {
      const int c = (j & 7) + 8 * (j >> 5);
      qs[j] = c < G ? q4[c * 4 + ((j >> 3) & 3)] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const float r0 = p.radius0[qi];
  int vcount = p.vc[qi], dcount = p.dc[qi], it = p.own[qi];
  bool finished = false;
  int32_t* vis = p.visited + (long long)qi * p.words;
  __syncwarp();
  float4 q0[4];   // the lane's first 16 components: all of them at m <= 128
#pragma unroll
  for (int k = 0; k < 4; ++k) q0[k] = qs[k * 8 + s];

  while (it < p.max_iters) {
    ++it;
    // explorationRadius: the eps-scaled kr-th pool distance
    const float er = __fmul_rn(fminf(pd[p.kr - 1], r0), p.eps);

    // ---- the first candidate in pool order; the live entries compacted
    // (in pool order they are sorted: only evicted holes sit between them)
    int pn = 0, cur_pos = -1, cur_c = -1;
    for (int b0 = 0; b0 < w; b0 += 32) {
      const int pos = b0 + lane;
      float d = 0.f;
      int id = -1;
      unsigned char ex = 0;
      if (pos < w) {
        d = pd[pos];
        id = pi[pos];
        ex = pe[pos];
      }
      const bool live = id >= 0;
      const unsigned lb = __ballot_sync(FULL, live);
      const unsigned cb = __ballot_sync(FULL, live && !ex && d <= er);
      if (live) {
        const int c = pn + __popc(lb & lt);
        ck[c] = lex_key(d, id);
        ce[c] = ex;
      }
      if (cur_pos < 0 && cb) {
        const int l = __ffs(cb) - 1;
        cur_pos = b0 + l;
        cur_c = pn + __popc(lb & ((1u << l) - 1u));
      }
      pn += __popc(lb);
    }
    if (cur_pos < 0) {   // no candidate: done, and done never clears
      finished = true;
      break;
    }
    const int cur = min(max(pi[cur_pos], 0), p.n - 1);

    // ---- the block row into shared memory, the adjacency row and the
    // expanded node's visited word into registers
    const uint8_t* xrow = p.x + (long long)cur * p.x_row;
    for (int v = lane; v < e * G; v += 32) cp_async16(row + v * 16, xrow + (long long)v * 16);
    int nb[EV_MAX];
    const int32_t* nrow = p.nbr + (long long)cur * p.nbr_row;
#pragma unroll
    for (int v = 0; v < EV_MAX; ++v) {
      const int j = lane + 32 * v;
      nb[v] = (v < ev && j < e) ? __ldg(nrow + j) : -1;
    }
    long long cw;
    unsigned cm1, cm2;
    slot(cur, p.hash_bits, p.exact, cw, cm1, cm2);
    const int cmask = (int)(cm1 | cm2);
    const int cword = lane == 0 ? vis[cw] : 0;

    // ---- the neighbours' valid bytes and visited words, the expanded
    // node's bits or-ed in (its store comes after these loads)
    unsigned char vb[EV_MAX];
    int wv[EV_MAX];
    unsigned sm1[EV_MAX], sm2[EV_MAX];
#pragma unroll
    for (int v = 0; v < EV_MAX; ++v) {
      vb[v] = 0;
      wv[v] = 0;
      sm1[v] = sm2[v] = 0;
      if (v < ev && nb[v] >= 0) {
        const int sid = min(nb[v], p.n - 1);
        long long wn;
        slot(sid, p.hash_bits, p.exact, wn, sm1[v], sm2[v]);
        vb[v] = __ldg(p.valid + sid);
        wv[v] = vis[wn] | (wn == cw ? cmask : 0);
      }
    }

    // ---- pool membership of the neighbours, while those loads fly: not
    // among the pool's ids as they stood at the step's start (no dedupe
    // within the row)
    unsigned livem = 0, inpool = 0;
#pragma unroll
    for (int v = 0; v < EV_MAX; ++v)
      if (v < ev && nb[v] >= 0) livem |= 1u << v;
    {
      const int4* pi4 = reinterpret_cast<const int4*>(pi);
#pragma unroll 4
      for (int i = 0; i < (w4 >> 2); ++i) {
        const int4 z = pi4[i];
#pragma unroll
        for (int v = 0; v < EV_MAX; ++v) {
          if ((livem >> v) & 1u) {
            if (z.x == nb[v] || z.y == nb[v] || z.z == nb[v] || z.w == nb[v]) inpool |= 1u << v;
          }
        }
      }
    }
    // live neighbours: valid, not seen, not in the pool; their edge
    // positions listed in edge order
    unsigned okm = 0;
    int nok = 0;
#pragma unroll
    for (int v = 0; v < EV_MAX; ++v) {
      if (v < ev) {
        const bool seen = (wv[v] & (int)sm1[v]) && (wv[v] & (int)sm2[v]);
        const bool ok = ((livem & ~inpool) >> v) & 1u && vb[v] && !seen;
        const unsigned ob = __ballot_sync(FULL, ok);
        if (ok) {
          okm |= 1u << v;
          okj[nok + __popc(ob & lt)] = lane + 32 * v;
        }
        nok += __popc(ob);
      }
    }

    // ---- the live neighbours' distances, eight lanes a neighbour.  The
    // sum runs in the order of PyTorch's CUDA reduction of a row of 128 R
    // floats (ATen/native/cuda/Reduce.cuh: 32 threads, thread t summing the
    // 4-float vectors t, t + 32, ... into one accumulator per component,
    // then ((a0 + a1) + a2) + a3, then a shuffle tree pairing t with
    // t + 16, t + 8, ...).  Lane s holds threads 4s..4s+3 (16 codes of each
    // 128), so the xor shuffles 4, 2, 1 then the lane's own pairs
    // reproduce that tree: the distances equal the step loop's bit for bit.
    cp_async_wait_all();
    __syncwarp();
#pragma unroll 2
    for (int r = 0; r < (nok + 3) >> 2; ++r) {
      const int o = 4 * r + g;
      const int j = o < nok ? okj[o] : -1;
      float acc[4][4];
      if (j >= 0 && s < G) {
        const unsigned char* rj = row + j * m;
        squares<SIGNED, true>(*reinterpret_cast<const uint4*>(rj + s * 16), q0, acc);
        for (int t = 1; t < V; ++t) {
          const int c = s + 8 * t;
          if (c < G) {
            float4 qt[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) qt[k] = qs[(t * 4 + k) * 8 + s];
            squares<SIGNED, false>(*reinterpret_cast<const uint4*>(rj + c * 16), qt, acc);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[k][i] = 0.f;
      }
      float gk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        gk[k] = __fadd_rn(__fadd_rn(__fadd_rn(acc[k][0], acc[k][1]), acc[k][2]), acc[k][3]);
        gk[k] = __fadd_rn(gk[k], __shfl_xor_sync(FULL, gk[k], 4));
        gk[k] = __fadd_rn(gk[k], __shfl_xor_sync(FULL, gk[k], 2));
        gk[k] = __fadd_rn(gk[k], __shfl_xor_sync(FULL, gk[k], 1));
      }
      if (s == 0 && j >= 0) nds[j] = sqrtf(__fadd_rn(__fadd_rn(gk[0], gk[2]), __fadd_rn(gk[1], gk[3])));
    }
    __syncwarp();   // nds written, every lane's visited load consumed
    if (lane == 0) {
      vis[cw] = cword | cmask;
      ce[cur_c] = 1;
    }

    // ---- counts, and the admitted neighbours (d <= er) in edge order
    int an = 0;
    dcount += nok;
#pragma unroll
    for (int v = 0; v < EV_MAX; ++v) {
      if (v < ev) {
        vcount += __popc(__ballot_sync(FULL, (livem >> v) & 1u));
        const bool ok = (okm >> v) & 1u;
        const float d = ok ? nds[lane + 32 * v] : 0.f;
        const bool adm = ok && d <= er;
        const unsigned ab = __ballot_sync(FULL, adm);
        if (adm) ak[an + __popc(ab & lt)] = lex_key(d, nb[v]);
        an += __popc(ab);
      }
    }
    __syncwarp();

    // ---- the merge in (d, id) order, the pool first on equal keys, the
    // first w ranks kept, expanded entries ranked >= k evicted.  An
    // admitted entry a ranks after lo_a pool entries (those <= its key)
    // and after the admitted entries before it; pool entry c ranks after
    // the admitted entries with lo_a <= c.
    for (int a = lane; a < an; a += 32) {
      const long long key = ak[a];
      int lo = 0, hi = pn;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ck[mid] <= key) lo = mid + 1;
        else hi = mid;
      }
      int ra = 0;
#pragma unroll 4
      for (int o = 0; o < an; ++o) {
        const long long ko = ak[o];
        ra += ko < key || (ko == key && o < a);
      }
      slo[ra] = lo;
      const int rank = lo + ra;
      if (rank < w) {
        pd[rank] = key_d(key);
        pi[rank] = key_id(key);
        pe[rank] = 0;
      }
    }
    __syncwarp();
    for (int c = lane; c < pn; c += 32) {
      int lo = 0, hi = an;   // admitted entries with slo <= c
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (slo[mid] <= c) lo = mid + 1;
        else hi = mid;
      }
      const int rank = c + lo;
      if (rank < w) {
        const long long key = ck[c];
        const bool evict = ce[c] && rank >= p.k;
        pd[rank] = evict ? inf : key_d(key);
        pi[rank] = evict ? -1 : key_id(key);
        pe[rank] = evict ? 0 : ce[c];
      }
    }
    for (int j = pn + an + lane; j < w; j += 32) {
      pd[j] = inf;
      pi[j] = -1;
      pe[j] = 0;
    }
    __syncwarp();
  }

  // ---- write back
  for (int j = lane; j < w; j += 32) {
    p.pool_d[qoff + j] = pd[j];
    p.pool_i[qoff + j] = pi[j];
    p.pool_e[qoff + j] = pe[j];
  }
  if (lane == 0) {
    if (finished) p.done[qi] = 1;
    p.vc[qi] = vcount;
    p.dc[qi] = dcount;
    p.own[qi] = it;
    atomicMax(p.steps, (unsigned long long)it);
  }
}

template <bool SIGNED>
int launch(const Params& p, int grid, int warps, int smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        traverse_kernel<SIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
  }
  traverse_kernel<SIGNED><<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Runs every query of a block-mode graph_search (p = 1, L2 over int8 or
// uint8 block rows) on `stream` of `device` to done or max_iters, in place
// on the state; see graph/search.py::_Loop for the buffers.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue / cudaErrorMisalignedAddress for arguments the
// kernel does not take.
int ngt_traverse(const void* x, long long x_row, const void* nbr, long long nbr_row,
                 const void* valid, const void* q, const void* radius0, void* pool_d,
                 void* pool_i, void* pool_e, void* visited, long long words, void* done,
                 void* vc, void* dc, void* own, void* steps, int b, int n, int e, int m, int w,
                 int k, int kr, int hash_bits, int exact, int max_iters, float eps,
                 int uint8_codes, int device, void* stream) {
  if (b <= 0 || n <= 0 || e <= 0 || e > E_MAX || m <= 0 || m % 16 != 0 || w <= 0 || k < 1 ||
      k > w || kr < 1 || kr > k || hash_bits < 5 || hash_bits > 31 || x_row % 16 != 0)
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) & 15)
    return int(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const int bytes = layout(w, e, m).bytes;
  int warps = SMEM_LIMIT / bytes;
  if (warps < 1) return int(cudaErrorInvalidValue);
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  const int smem = warps * bytes;
  Params p{static_cast<const uint8_t*>(x), x_row, static_cast<const int32_t*>(nbr), nbr_row,
           static_cast<const uint8_t*>(valid), static_cast<const float*>(q),
           static_cast<const float*>(radius0), static_cast<float*>(pool_d),
           static_cast<int32_t*>(pool_i), static_cast<uint8_t*>(pool_e),
           static_cast<int32_t*>(visited), words, static_cast<uint8_t*>(done),
           static_cast<int32_t*>(vc), static_cast<int32_t*>(dc), static_cast<int32_t*>(own),
           static_cast<unsigned long long*>(steps), b, n, e, m, w, k, kr, hash_bits, exact,
           max_iters, eps};
  const int grid = (b + warps - 1) / warps;
  return uint8_codes ? launch<false>(p, grid, warps, smem, stream)
                     : launch<true>(p, grid, warps, smem, stream);
}

// Shared memory of one query's warp at pool width w, e edges and query
// width m (ops/traverse.py::smem_bytes computes the same on the host).
int ngt_traverse_smem(int w, int e, int m) { return layout(w, e, m).bytes; }

}  // extern "C"
