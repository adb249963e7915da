// Window-min scan of the bulk exact-KNN build, hand-written for Hopper.
//
// Replaces the TPU kernel ngt_tpu/ops/pallas_scan.py::fused_scan_candidates
// (body _kernel).  For every query q and every WINDOW-row window w of the
// corpus it returns
//     out_d[q, w] = min over rows r of w of  ss[r] - 2 * <q, x_r>
//     out_i[q, w] = the global row r reaching that minimum (lowest r on ties)
// with bf16 inputs and f32 products; rows whose ss is BIG (1e30) are masked
// by construction.  The [queries, rows] score tile never leaves registers,
// which is the point of the kernel: written out, it would be the whole
// corpus-by-queries product in device memory per call.
//
// What bounds it: operations.  One call does 2*B*N*D flop (4096 x 2^20 x
// 128 at the 1M build: 1.1e12, 1.11 ms at the H100's 989 TFLOP/s of bf16)
// and must move q, x, ss and the outputs once (0.54 GB, 0.16 ms at 3.35
// TB/s).  In practice an H100 runs at its 700 W power limit while the
// kernel runs, below its top clock, so every joule spent on data movement
// or on the epilogue lowers the clock the products run at.
//
// The design: one persistent, warp-specialised CTA per SM of 3 warpgroups.
// A work unit is (a tile of QT queries, a run of R=32 consecutive windows);
// units are numbered run-major, so the CTAs in flight share a few runs of
// x, which come from device memory about once and from L2 for the other
// query tiles.
//  - Warpgroup 0 is the producer (setmaxnreg 40): one thread loads the
//    unit's query tile once by TMA ([128 x 64] bf16 K-major chunks, 128-byte
//    swizzle; TMA fills rows past b with zeros) and streams x through a ring
//    of S stages of one [128 rows x 64 columns] chunk each (16 KB) with
//    cp.async.bulk.tensor and full/empty mbarriers; with a window's first
//    chunk it copies the window's 512 bytes of ss (cp.async.bulk) into one
//    of NSS slots.  Copies run ahead of the product and overlap it; no
//    consumer thread spends registers or instructions on them (the WMMA
//    kernel before this one copied global->register->shared synchronously).
//  - Warpgroups 1 and 2 are consumers (setmaxnreg 232), QT/2 queries each.
//    Per window chunk they issue wgmma.mma_async m64n128k16.f32.bf16.bf16,
//    4 k-steps for each m64 block of their queries, A (queries) and B (the
//    x chunk) read from shared memory by descriptor (mma.sync cannot reach
//    Hopper's bf16 rate).  One wgmma group a chunk; a chunk's stage goes
//    back to the producer once the next chunk's group is issued and its own
//    has retired.
//  - The epilogue stays in registers (the WMMA kernel stored the score tile
//    to shared memory and read it back).  In the m64n128 accumulator layout
//    a thread holds 2 query rows x 32 of the window's 128 rows; it takes
//    fmaf(-2, acc, ss[row]) and a strict-< running min in ascending row
//    order, then 2 __shfl_xor_sync rounds over the lane quad compare
//    (value, row) lexicographically: lowest row on ties, exactly.  The
//    (min, row) pairs of FL=16 windows are staged in shared memory and
//    written out as contiguous runs of each query row.
//  - Tile sizes.  QT = 256 queries at d = 128 (each consumer holds two m64
//    accumulators, 128 registers), 128 at wider rows, where a 256-query
//    tile leaves too little shared memory for the ring.  At 4096 queries x
//    is read from L2 16 times per call at d=128 (4 GB), against 64 times
//    for the WMMA kernel's 64-query tiles; at the power limit, halving
//    that traffic from 128-query tiles was faster.  One accumulator set per
//    consumer: two alternating sets (the epilogue of window w beside the
//    product of w+1) and ping-pong ordering of the two consumers were no
//    faster at d=128, as the card was already at its power limit, and two
//    sets leave no registers for 256-query tiles.
//
// Limits: d (the padded row width) a multiple of 128 and at most 512; n a
// multiple of 128; q, x and ss 16-byte aligned (TMA).  Shared-memory plan:
// the query tile QT/128 x d/64 x 16 KB, the ring S x 16 KB, NSS x 512 B of
// ss, the output staging 2 x QT x 17 x 4 B, 2S+NSS+2 mbarriers and 1 KB of
// alignment slack: S = 7 at d = 128, 8 at 256, 6 at 384, 4 at 512, for
// 217,200-218,272 bytes against the 232,448 a block may use.  Offsets into
// the outputs are 64-bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WINDOW = 128;        // corpus rows per window
constexpr int KCOLS = 64;          // bf16 columns per chunk (128 B, the swizzle span)
constexpr int CHUNK_BYTES = 128 * KCOLS * 2;  // one [128 x 64] bf16 chunk
constexpr int SS_BYTES = WINDOW * 4;          // one window of ss
constexpr int R = 32;              // windows per unit
constexpr int FL = 16;             // windows per output flush
constexpr int SP = FL + 1;         // staging row stride (words), against bank conflicts
constexpr int THREADS = 384;
constexpr int D_MAX = 512;
constexpr int S_MAX = 8;
constexpr int SMEM_MAX = 232448;   // 227 KB, the most a block may use
constexpr int NSS = 4;             // ss slots: the window in its epilogue and 3 ahead
constexpr int ERR_TENSOR_MAP = 1000000;  // + CUresult of a failed encode

// queries per unit: 256 (2 consumers x 2 m64 accumulators) at d = 128,
// where the query tile is small; 128 (2 x 1) at wider rows
__host__ __device__ constexpr int qt_for(int kc) { return kc == 2 ? 256 : 128; }

struct Plan {  // byte offsets in shared memory, and its size
  uint32_t x_off, ss_off, stg_off, bar_off, bytes;
};

__host__ __device__ inline Plan make_plan(int d, int stages) {
  const int kc = d / KCOLS;
  Plan p;
  p.x_off = uint32_t(qt_for(kc) / 128 * kc) * CHUNK_BYTES;
  p.ss_off = p.x_off + uint32_t(stages) * CHUNK_BYTES;
  p.stg_off = p.ss_off + NSS * SS_BYTES;
  p.bar_off = p.stg_off + 2 * qt_for(kc) * SP * 4;  // staged (min, id) pairs
  // full[stages], empty[stages], ss_empty[NSS], q_full, q_empty; + alignment slack
  p.bytes = p.bar_off + uint32_t(2 * stages + NSS + 2) * 8 + 1024;
  return p;
}

inline int stages_for(int d) {
  const int fixed = int(make_plan(d, 0).bytes);
  int s = (SMEM_MAX - fixed) / (CHUNK_BYTES + 16);
  return s < S_MAX ? s : S_MAX;
}

// ---- PTX wrappers -----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// TMA writes: rows of 128 B, 8-row groups 1024 B apart (SBO), tile base
// 1024-byte aligned.  A step of 16 bf16 along K adds 32 B (2 in the
// address field) inside the swizzle atom.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the kernel -------------------------------------------------------

template <int KC>
struct Consumer {
  static constexpr int NACC = qt_for(KC) / 128;  // m64 accumulators per consumer
  static constexpr int ROWS = NACC * 64;          // query rows per consumer

  // shared memory (shared-window addresses and generic pointers)
  uint32_t q_addr, x_addr, full, empty, ss_empty;
  const float* ss_slots;
  float* stg_d;
  int32_t* stg_i;
  // this consumer
  int cw, t, warp, lane, stages;
  // problem
  float* out_d;
  int32_t* out_i;
  int b, nwin;
  // unit: first query, first window, windows, and the CTA's window count
  // before it (the ss slot of window j is (wc0 + j) % NSS)
  int q0, w0, nw;
  uint32_t wc0;

  __device__ __forceinline__ void release(uint32_t it) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + (it % stages) * 8);
  }

  // the product of window j of the unit, chunk by chunk (one wgmma group a
  // chunk; a chunk's stage goes back once the next chunk's group is issued
  // and its own has retired), then the window's epilogue
  __device__ __forceinline__ void scan_window(int j, uint32_t& it, float (&acc)[NACC][64]) {
#pragma unroll
    for (int a = 0; a < NACC; ++a) fence_acc(acc[a]);
#pragma unroll
    for (int k = 0; k < KC; ++k, ++it) {
      const uint32_t s = it % stages;
      mbar_wait(full + s * 8, (it / stages) & 1);
      const uint64_t db = sw128_desc(x_addr + s * CHUNK_BYTES);
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        // rows cw*ROWS + a*64 of the tile: 128-row half h, 64-row offset
        const int r0 = cw * ROWS + a * 64;
        const uint64_t da =
            sw128_desc(q_addr + ((r0 >> 7) * KC + k) * CHUNK_BYTES + (r0 & 127) * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16(acc[a], da + 2 * kk, db + 2 * kk, (k | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (k > 0) release(it - 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < NACC; ++a) fence_acc(acc[a]);
    release(it - 1);
    epilogue(j, acc);
  }

  // (min, argmin) of each query row over window j from the accumulators
  __device__ __forceinline__ void epilogue(int j, float (&acc)[NACC][64]) {
    const uint32_t slot_ss = (wc0 + uint32_t(j)) % NSS;
    const float* ssw = ss_slots + slot_ss * WINDOW;
    const int q4 = lane & 3;
    float b0[NACC], b1[NACC];
    int c0[NACC], c1[NACC];
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const int c = 8 * g + 2 * q4;
      const float2 sv = *reinterpret_cast<const float2*>(ssw + c);
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        const float v00 = fmaf(-2.0f, acc[a][4 * g + 0], sv.x);
        const float v01 = fmaf(-2.0f, acc[a][4 * g + 1], sv.y);
        const float v10 = fmaf(-2.0f, acc[a][4 * g + 2], sv.x);
        const float v11 = fmaf(-2.0f, acc[a][4 * g + 3], sv.y);
        if (g == 0) {
          b0[a] = v00; c0[a] = c;
          b1[a] = v10; c1[a] = c;
        } else {
          if (v00 < b0[a]) { b0[a] = v00; c0[a] = c; }
          if (v10 < b1[a]) { b1[a] = v10; c1[a] = c; }
        }
        if (v01 < b0[a]) { b0[a] = v01; c0[a] = c + 1; }
        if (v11 < b1[a]) { b1[a] = v11; c1[a] = c + 1; }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ss_empty + slot_ss * 8);
    const int slot = j % FL;
    const int base_row = (w0 + j) * WINDOW;
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float o0 = __shfl_xor_sync(0xffffffffu, b0[a], off);
        const int i0 = __shfl_xor_sync(0xffffffffu, c0[a], off);
        const float o1 = __shfl_xor_sync(0xffffffffu, b1[a], off);
        const int i1 = __shfl_xor_sync(0xffffffffu, c1[a], off);
        if (o0 < b0[a] || (o0 == b0[a] && i0 < c0[a])) { b0[a] = o0; c0[a] = i0; }
        if (o1 < b1[a] || (o1 == b1[a] && i1 < c1[a])) { b1[a] = o1; c1[a] = i1; }
      }
      // every lane of the quad holds both results: lane 0 writes row r, lane 1 row r+8
      if (q4 < 2) {
        const int r = cw * ROWS + a * 64 + warp * 16 + (lane >> 2) + 8 * q4;
        stg_d[r * SP + slot] = q4 ? b1[a] : b0[a];
        stg_i[r * SP + slot] = base_row + (q4 ? c1[a] : c0[a]);
      }
    }
    if (slot == FL - 1 || j == nw - 1) flush(j - slot, slot + 1);
  }

  // windows [g0, g0+cnt) of this consumer's query rows to device memory
  __device__ __forceinline__ void flush(int g0, int cnt) {
    named_sync(1 + cw, 128);
#pragma unroll 2
    for (int e = t; e < ROWS * FL; e += 128) {
      const int r = e / FL, c = e % FL;
      const int q = q0 + cw * ROWS + r;
      if (c < cnt && q < b) {
        const size_t o = size_t(q) * nwin + (w0 + g0 + c);
        const int sr = (cw * ROWS + r) * SP + c;
        out_d[o] = stg_d[sr];
        out_i[o] = stg_i[sr];
      }
    }
    named_sync(1 + cw, 128);
  }
};

template <int KC>
__global__ void __launch_bounds__(THREADS, 1)
window_scan_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap xmap,
                   const float* __restrict__ ss, float* __restrict__ out_d,
                   int32_t* __restrict__ out_i, int b, int nwin, int stages) {
  constexpr int QT = qt_for(KC);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  const Plan p = make_plan(KC * KCOLS, stages);
  const uint32_t full = base + p.bar_off;           // [stages]
  const uint32_t empty = full + stages * 8;         // [stages]
  const uint32_t ss_empty = empty + stages * 8;     // [NSS]
  const uint32_t q_full = ss_empty + NSS * 8;
  const uint32_t q_empty = q_full + 8;

  const int ntiles = (b + QT - 1) / QT;
  const int nruns = (nwin + R - 1) / R;
  const int units = ntiles * nruns;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s * 8, 1);
      mbar_init(empty + s * 8, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < NSS; ++s) mbar_init(ss_empty + s * 8, 8);
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&qmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
      uint32_t it = 0, wc = 0, ul = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++ul) {
        const int run = u / ntiles, tile = u - run * ntiles;
        const int w0 = run * R;
        const int nw = min(R, nwin - w0);
        // the query tile goes in as soon as the consumers are done with the
        // last one; until then x chunks of this unit keep the ring full
        bool q_pending = true;
        const uint32_t q_par = (ul & 1) ^ 1;
        auto load_q = [&]() {
          mbar_expect_tx(q_full, p.x_off);  // the query tile fills [0, x_off)
          for (int h = 0; h < QT / 128; ++h)
            for (int kq = 0; kq < KC; ++kq)
              tma_load_2d(base + (h * KC + kq) * CHUNK_BYTES, &qmap, kq * KCOLS,
                          tile * QT + h * 128, q_full);
          q_pending = false;
        };
        for (int j = 0; j < nw; ++j, ++wc) {
          const uint32_t ss_bar = ss_empty + (wc % NSS) * 8;
          const uint32_t ss_par = ((wc / NSS) & 1) ^ 1;
          for (int k = 0; k < KC; ++k, ++it) {
            const uint32_t s = it % stages;
            const uint32_t e_par = ((it / stages) & 1) ^ 1;
            while (true) {
              if (q_pending && mbar_test(q_empty, q_par)) load_q();
              if (mbar_test(empty + s * 8, e_par) && (k != 0 || mbar_test(ss_bar, ss_par)))
                break;
            }
            const uint32_t fb = full + s * 8;
            mbar_expect_tx(fb, CHUNK_BYTES + (k == 0 ? SS_BYTES : 0));
            tma_load_2d(base + p.x_off + s * CHUNK_BYTES, &xmap, k * KCOLS,
                        (w0 + j) * WINDOW, fb);
            if (k == 0)
              bulk_load(base + p.ss_off + (wc % NSS) * SS_BYTES,
                        ss + size_t(w0 + j) * WINDOW, SS_BYTES, fb);
          }
        }
        if (q_pending) {
          mbar_wait(q_empty, q_par);
          load_q();
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    Consumer<KC> c;
    c.q_addr = base;
    c.x_addr = base + p.x_off;
    c.full = full;
    c.empty = empty;
    c.ss_empty = ss_empty;
    c.ss_slots = reinterpret_cast<const float*>(smem + p.ss_off);
    c.stg_d = reinterpret_cast<float*>(smem + p.stg_off);
    c.stg_i = reinterpret_cast<int32_t*>(smem + p.stg_off + QT * SP * 4);
    c.cw = wg - 1;
    c.t = threadIdx.x - 128 * wg;
    c.warp = c.t >> 5;
    c.lane = c.t & 31;
    c.stages = stages;
    c.out_d = out_d;
    c.out_i = out_i;
    c.b = b;
    c.nwin = nwin;
    float acc[Consumer<KC>::NACC][64];
#pragma unroll
    for (int a = 0; a < Consumer<KC>::NACC; ++a)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[a][i] = 0.f;
    uint32_t it = 0, wc = 0, ul = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++ul) {
      const int run = u / ntiles, tile = u - run * ntiles;
      c.q0 = tile * QT;
      c.w0 = run * R;
      c.nw = min(R, nwin - c.w0);
      c.wc0 = wc;
      wc += c.nw;
      mbar_wait(q_full, ul & 1);
      for (int j = 0; j < c.nw; ++j) c.scan_window(j, it, acc);
      __syncwarp();
      if (c.lane == 0) mbar_arrive(q_empty);  // the query tile is free
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda at link
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// [rows x d] bf16 row-major, boxes of [128 rows x 64 columns], 128 B swizzle;
// rows past `rows` read as zeros
int encode_rows(CUtensorMap* map, const void* ptr, int rows, int d) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cuuint64_t(d), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(d) * 2};
  const cuuint32_t box[2] = {KCOLS, 128};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + int(r);
}

template <int KC>
int launch(const CUtensorMap& qmap, const CUtensorMap& xmap, const void* ss, void* out_d,
           void* out_i, int b, int nwin, int stages, int grid, void* stream) {
  const Plan p = make_plan(KC * KCOLS, stages);
  cudaError_t err = cudaFuncSetAttribute(window_scan_kernel<KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(p.bytes));
  if (err != cudaSuccess) return int(err);
  window_scan_kernel<KC><<<grid, THREADS, p.bytes, static_cast<cudaStream_t>(stream)>>>(
      qmap, xmap, static_cast<const float*>(ss), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i), b, nwin, stages);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the scan on `stream` (a cudaStream_t) of device `device`.
// q [b, d] bf16, x [n, d] bf16, ss [n] f32 -> out_d, out_i [b, n/128].
// Returns cudaGetLastError() after the launch (0 = launched), or an error
// code of its own (see ngt_cuda_error_string).
int ngt_window_scan(const void* q, const void* x, const void* ss, void* out_d,
                    void* out_i, int b, int n, int d, int device, void* stream) {
  if (b <= 0 || n <= 0 || n % WINDOW != 0 || d <= 0 || d % 128 != 0 || d > D_MAX)
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x) |
       reinterpret_cast<uintptr_t>(ss)) & 15)
    return int(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  CUtensorMap qmap, xmap;
  int e = encode_rows(&qmap, q, b, d);
  if (e != 0) return e;
  e = encode_rows(&xmap, x, n, d);
  if (e != 0) return e;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const int nwin = n / WINDOW;
  const int qt = qt_for(d / KCOLS);
  const long long units = (long long)((b + qt - 1) / qt) * ((nwin + R - 1) / R);
  const int grid = int(units < sms ? units : sms);
  const int stages = stages_for(d);
  switch (d / KCOLS) {
    case 2: return launch<2>(qmap, xmap, ss, out_d, out_i, b, nwin, stages, grid, stream);
    case 4: return launch<4>(qmap, xmap, ss, out_d, out_i, b, nwin, stages, grid, stream);
    case 6: return launch<6>(qmap, xmap, ss, out_d, out_i, b, nwin, stages, grid, stream);
    default: return launch<8>(qmap, xmap, ss, out_d, out_i, b, nwin, stages, grid, stream);
  }
}

const char* ngt_cuda_error_string(int err) {
  if (err >= ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared-memory bytes and ring stages of the scan at row width d (for the
// build report); 0 stages if d is outside the kernel's limits.
int ngt_window_scan_plan(int d, int* smem_bytes) {
  if (d <= 0 || d % 128 != 0 || d > D_MAX) return 0;
  const int stages = stages_for(d);
  *smem_bytes = int(make_plan(d, stages).bytes);
  return stages;
}

}  // extern "C"
