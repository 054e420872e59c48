// One train step of a WIDE sigmoid/BCE output layer, for NVIDIA Hopper
// (sm_90a): logits = h @ W + b, the BCE-with-logits sum, dW, db, dh (with the
// PRE-update W) and the AdamW update of W, b and their moments.
//
// Replaces the TPU kernel of vae_los_angeles_tpu/ops/pallas/fused_wide.py,
// fused_wide_output_step (one column-block sweep over the d_in x D output
// layer of RNA->DNA's DecoderB at whole-methylome width, D = 450,000):
//   bce   = sum(max(l, 0) - l * t + log1p(exp(-|l|))),
//   dy    = sigmoid(l) - t,  dW = h^T dy,  db = sum_rows dy,  dh = dy W^T,
//   AdamW in torch order: p *= 1 - lr * wd, then the bias-corrected step
//   (bias corrections at step + 1, computed by the caller).
//
// What bounds it on an H100: at batch 32 the bytes. W, m and v are d_in x D
// fp32 each (0.92 GB at 512 x 450,000); they are read and written once, the
// target read once: ~5.6 GB, ~1.7 ms at 3.35 TB/s. At batch 256 the
// operations: three n x d_in x D products, ~354 GFLOP, ~5.3 ms at the fp32
// rate of 67 TFLOP/s (the products are this kernel's own FMA loops, not the
// tensor cores).
//
// Two designs, by the batch; neither uses atomics, so the same inputs give
// the same bits.
//
// One sweep (n <= 32 rows and d_in <= 512, the training batch of the wide
// path): W is read from device memory once. The three-launch design below
// reads it three times (twice in its sweep, once more for dh) and writes and
// re-reads an n x D dy scratch, ~7.5 GB a step at B = 32. wide_one_sweep_kernel runs one
// persistent block of 512 threads on each of up to 132 SMs, each with a fixed
// range of 32-column tiles (so the order of every sum is fixed). h stays in
// shared memory for the whole sweep; each tile's W slice (d_in x 32) and
// target slice are copied into shared memory with cp.async, two buffers
// deep, the next tile's copy in flight while the current one computes. From
// that one copy of the pre-update W the block forms the logits, dy and the
// BCE partial, db and its AdamW, dW = h^T dy and the AdamW of W with m and v
// streamed once, and its share of dh = dy W^T, accumulated over its tiles in
// registers (32 x 512 fp32 over 512 threads: 32 a thread). Each block then
// writes its dh partial and wide_reduce_kernel adds the partials and the
// loss partials in a fixed order: two launches. The logits, dy, db and dW are
// summed in the three-launch design's order, so they give its bits.
//
// Three launches (more rows, where dh does not fit in registers):
//   1. wide_sweep_kernel: one block per 64-column tile. Phase 1 computes the
//      tile's logits for all rows (h and W staged through shared memory in
//      chunks of 32 along d_in, a 4 x 4 register tile per thread), the BCE
//      partial of the block and dy, kept whole in shared memory (n x 64) and
//      written to a scratch n x D array for launch 2. Phase 2 computes db
//      (one thread a column, rows in order) and dW = h^T dy in 64-row chunks
//      of d_in, applies AdamW to each chunk as it is finished and writes the
//      new W, m and v into separate outputs: W is never written in place, so
//      launch 2 still reads the pre-update W.
//   2. wide_dh_partial_kernel: dh = dy W^T split over D into P fixed
//      chunks; each block writes a 64 x 64 tile of its chunk's partial.
//   3. wide_reduce_kernel: dh = the P partials added in order; its last
//      block adds the launch-1 loss partials in a fixed tree.
// The ragged tail (D not a multiple of 64) is masked inside the kernels:
// nothing is padded, and exactly D columns are written.
//
// Plain C interface, built with nvcc and called through ctypes; the entry
// returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int SWEEP_THREADS = 512;   // the one-sweep kernel: 16 warps
constexpr int SWEEP_BLOCKS = 132;    // one a SM of an H100 (fixed: the same bits on any card)
constexpr int SWEEP_ROWS = 32;       // rows the one-sweep kernel takes (h and dh padded to them)
constexpr int SWEEP_MAX_K = 512;     // d_in it takes: a warp holds dh of one 32-wide chunk
constexpr int CT = 32;               // columns of a one-sweep tile
constexpr int WLD = CT + 1;          // row stride of a W tile in shared memory (no bank conflicts)
constexpr int DYT_LD = SWEEP_ROWS + 4;  // row stride of dy^T (16-byte rows, 4-way stores)
constexpr int TC = 64;        // columns of W a sweep block owns
constexpr int RB = 64;        // rows of the logits tile
constexpr int KC = 32;        // d_in chunk of the logits product
constexpr int KB = 64;        // d_in rows of a dW chunk
constexpr int RC = 32;        // batch rows per dW chunk step
constexpr int DC = 32;        // D chunk of the dh product
constexpr int LDT = 68;       // padded stride of the transposed tiles (16-byte aligned)
constexpr int TILE_T = 32 * LDT;  // floats of one transposed 32 x 64 tile
constexpr int TARGET_BLOCKS = 264;  // 2 blocks on each of the 132 SMs

constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float OMB1 = static_cast<float>(1.0 - 0.9);    // as (1.0 - ADAM_B1) in Python
constexpr float OMB2 = static_cast<float>(1.0 - 0.999);
constexpr float ADAM_EPS = 1e-8f;

// torch's order of operations for one AdamW leaf, every step rounded
// separately (no contraction into FMAs), as ops/optim.adamw_update does it.
__device__ __forceinline__ void adamw(float& p, float& m, float& v, float g, float bc1, float bc2,
                                      float lr, float decay) {
    m = __fadd_rn(__fmul_rn(B1, m), __fmul_rn(OMB1, g));
    v = __fadd_rn(__fmul_rn(B2, v), __fmul_rn(OMB2, __fmul_rn(g, g)));
    p = __fmul_rn(p, decay);
    const float step = __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m, bc1)),
                                 __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), ADAM_EPS));
    p = __fsub_rn(p, step);
}

__device__ __forceinline__ float bce_term(float l, float t) {
    return fmaxf(l, 0.f) - l * t + log1pf(expf(-fabsf(l)));
}

__device__ __forceinline__ float block_sum(float x, float* red) {
    red[threadIdx.x] = x;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
        __syncthreads();
    }
    return red[0];
}

// Launch 1. Dynamic shared memory: hs (TILE_T) | ws (KC * TC) | dys (n_pad * TC).
__global__ void __launch_bounds__(THREADS)
wide_sweep_kernel(const float* __restrict__ h, const float* __restrict__ t,
                  const float* __restrict__ w, const float* __restrict__ b,
                  const float* __restrict__ mw, const float* __restrict__ vw,
                  const float* __restrict__ mb, const float* __restrict__ vb,
                  const float* __restrict__ scal, int n, int K, long long D,
                  float* __restrict__ nw, float* __restrict__ nb, float* __restrict__ nmw,
                  float* __restrict__ nvw, float* __restrict__ nmb, float* __restrict__ nvb,
                  float* __restrict__ dy, float* __restrict__ loss_part) {
    extern __shared__ __align__(16) float smem[];
    float* hs = smem;                 // phase 1: h chunk transposed [KC][LDT]; phase 2: [RC][KB]
    float* ws = smem + TILE_T;        // W chunk [KC][TC]
    float* dys = ws + KC * TC;        // dy of the tile [n_pad][TC]
    __shared__ float red[THREADS];

    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const long long c0 = (long long)blockIdx.x * TC;
    const int n_pad = (n + RB - 1) / RB * RB;
    const float bc1 = scal[0], bc2 = scal[1], lr = scal[2], decay = scal[3];

    // ---- phase 1: logits, BCE partial, dy
    float loss = 0.f;
    for (int r0 = 0; r0 < n_pad; r0 += RB) {
        float acc[4][4] = {};
        for (int k0 = 0; k0 < K; k0 += KC) {
            for (int e = tid; e < RB * KC; e += THREADS) {
                const int r = e / KC, kk = e % KC;
                const int gr = r0 + r, gk = k0 + kk;
                hs[kk * LDT + r] = (gr < n && gk < K) ? h[(size_t)gr * K + gk] : 0.f;
            }
            for (int e = tid; e < KC * TC; e += THREADS) {
                const int kk = e / TC, c = e % TC;
                const int gk = k0 + kk;
                const long long gc = c0 + c;
                ws[kk * TC + c] = (gk < K && gc < D) ? w[(size_t)gk * D + gc] : 0.f;
            }
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < KC; ++kk) {
                const float4 a = *reinterpret_cast<const float4*>(&hs[kk * LDT + ty * 4]);
                const float4 bv = *reinterpret_cast<const float4*>(&ws[kk * TC + tx * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = r0 + ty * 4 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int lc = tx * 4 + j;
                const long long gc = c0 + lc;
                float d = 0.f;
                if (row < n && gc < D) {
                    const float l = acc[i][j] + b[gc];
                    const float tt = t[(size_t)row * D + gc];
                    loss += bce_term(l, tt);
                    d = 1.f / (1.f + expf(-l)) - tt;
                    dy[(size_t)row * D + gc] = d;
                }
                dys[row * TC + lc] = d;
            }
        }
    }
    const float total = block_sum(loss, red);  // its syncs also publish dys
    if (tid == 0) loss_part[blockIdx.x] = total;

    // ---- phase 2: db and its AdamW, one thread a column, rows in order
    if (tid < TC) {
        const long long gc = c0 + tid;
        if (gc < D) {
            float g = 0.f;
            for (int r = 0; r < n; ++r) g += dys[r * TC + tid];
            float p = b[gc], m = mb[gc], v = vb[gc];
            adamw(p, m, v, g, bc1, bc2, lr, decay);
            nb[gc] = p;
            nmb[gc] = m;
            nvb[gc] = v;
        }
    }
    // ---- dW = h^T dy in chunks of KB rows of d_in, each chunk's AdamW at once
    for (int kb = 0; kb < K; kb += KB) {
        float acc[4][4] = {};
        for (int rr = 0; rr < n; rr += RC) {
            for (int e = tid; e < RC * KB; e += THREADS) {
                const int r = e / KB, k = e % KB;
                const int gr = rr + r, gk = kb + k;
                hs[r * KB + k] = (gr < n && gk < K) ? h[(size_t)gr * K + gk] : 0.f;
            }
            __syncthreads();
#pragma unroll 8
            for (int r = 0; r < RC; ++r) {
                const float4 a = *reinterpret_cast<const float4*>(&hs[r * KB + ty * 4]);
                const float4 bv = *reinterpret_cast<const float4*>(&dys[(rr + r) * TC + tx * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int gk = kb + ty * 4 + i;
            if (gk >= K) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const long long gc = c0 + tx * 4 + j;
                if (gc >= D) continue;
                const size_t idx = (size_t)gk * D + gc;
                float p = w[idx], m = mw[idx], v = vw[idx];
                adamw(p, m, v, acc[i][j], bc1, bc2, lr, decay);
                nw[idx] = p;
                nmw[idx] = m;
                nvw[idx] = v;
            }
        }
    }
}

// Launch 2: partial[p] (n x K) = dy[:, chunk p] @ W[:, chunk p]^T, a 64 x 64
// tile of rows x d_in per block, the chunk's columns summed in order.
__global__ void __launch_bounds__(THREADS)
wide_dh_partial_kernel(const float* __restrict__ dy, const float* __restrict__ w, int n, int K,
                       long long D, long long chunk, float* __restrict__ partial) {
    __shared__ __align__(16) float ds[TILE_T];  // dy tile transposed [DC][LDT]
    __shared__ __align__(16) float wt[TILE_T];  // W tile transposed [DC][LDT]
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int k0 = blockIdx.x * 64, r0 = blockIdx.y * 64;
    const long long d_lo = (long long)blockIdx.z * chunk;
    const long long d_hi = d_lo + chunk < D ? d_lo + chunk : D;
    float acc[4][4] = {};
    for (long long d0 = d_lo; d0 < d_hi; d0 += DC) {
        for (int e = tid; e < 64 * DC; e += THREADS) {
            const int r = e / DC, dd = e % DC;
            const long long gd = d0 + dd;
            const bool in = gd < d_hi;
            ds[dd * LDT + r] = (in && r0 + r < n) ? dy[(size_t)(r0 + r) * D + gd] : 0.f;
            wt[dd * LDT + r] = (in && k0 + r < K) ? w[(size_t)(k0 + r) * D + gd] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int dd = 0; dd < DC; ++dd) {
            const float4 a = *reinterpret_cast<const float4*>(&ds[dd * LDT + ty * 4]);
            const float4 bv = *reinterpret_cast<const float4*>(&wt[dd * LDT + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
        }
        __syncthreads();
    }
    float* out = partial + (size_t)blockIdx.z * n * K;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty * 4 + i;
        if (r >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx * 4 + j;
            if (k < K) out[(size_t)r * K + k] = acc[i][j];
        }
    }
}

// Launch 3: dh = sum of the P partials in order; the last block adds the
// loss partials (fixed strided sums, then a fixed tree).
__global__ void __launch_bounds__(THREADS)
wide_reduce_kernel(const float* __restrict__ partial, int P, long long nk,
                   const float* __restrict__ loss_part, int n_loss, float* __restrict__ dh,
                   float* __restrict__ loss) {
    __shared__ float red[THREADS];
    if (blockIdx.x == gridDim.x - 1) {
        float s = 0.f;
        for (int i = threadIdx.x; i < n_loss; i += THREADS) s += loss_part[i];
        const float total = block_sum(s, red);
        if (threadIdx.x == 0) *loss = total;
        return;
    }
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= nk) return;
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += partial[(size_t)p * nk + idx];
    dh[idx] = s;
}

// cp.async of one float into shared memory; zeros where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// Shared memory of the one-sweep kernel, in floats: h [32][K4] | W tiles
// [2][K4][WLD] | target tiles [2][32][32] | dy [32 rows][32 cols] | dy^T
// [32 cols][DYT_LD] | the warps' loss sums [16].
__host__ __device__ inline size_t one_sweep_floats(int K4) {
    return (size_t)SWEEP_ROWS * K4 + 2 * (size_t)K4 * WLD + 3 * SWEEP_ROWS * CT +
           CT * DYT_LD + SWEEP_THREADS / 32;
}

// Copy tile ``c0`` (W rows 0..K4, columns c0..c0+31, and the target rows)
// into one buffer.
__device__ __forceinline__ void copy_tile(const float* __restrict__ w,
                                          const float* __restrict__ t, int n, int K, int K4,
                                          long long D, long long c0, float* ws, float* ts) {
    for (int e = threadIdx.x; e < K4 * CT; e += SWEEP_THREADS) {
        const int k = e / CT, c = e % CT;
        const bool ok = k < K && c0 + c < D;
        cp_async4(ws + k * WLD + c, ok ? w + (size_t)k * D + c0 + c : w, ok);
    }
    for (int e = threadIdx.x; e < SWEEP_ROWS * CT; e += SWEEP_THREADS) {
        const int r = e / CT, c = e % CT;
        const bool ok = r < n && c0 + c < D;
        cp_async4(ts + e, ok ? t + (size_t)r * D + c0 + c : t, ok);
    }
    cp_async_commit();
}

// The one-sweep step (file note). Block g owns tiles [g T / G, (g + 1) T / G)
// of the T = ceil(D / 32) column tiles; it writes partial[g] (n x K), its
// share of dh, and loss_part[g], the BCE sum of its tiles.
__global__ void __launch_bounds__(SWEEP_THREADS, 1)
wide_one_sweep_kernel(const float* __restrict__ h, const float* __restrict__ t,
                      const float* __restrict__ w, const float* __restrict__ b,
                      const float* __restrict__ mw, const float* __restrict__ vw,
                      const float* __restrict__ mb, const float* __restrict__ vb,
                      const float* __restrict__ scal, int n, int K, long long D,
                      float* __restrict__ nw, float* __restrict__ nb, float* __restrict__ nmw,
                      float* __restrict__ nvw, float* __restrict__ nmb, float* __restrict__ nvb,
                      float* __restrict__ partial, float* __restrict__ loss_part) {
    extern __shared__ __align__(16) float smem[];
    const int K4 = (K + 3) & ~3;
    float* hs = smem;                              // [32][K4]
    float* wbuf = hs + SWEEP_ROWS * K4;            // [2][K4][WLD]
    float* tbuf = wbuf + 2 * (size_t)K4 * WLD;     // [2][32][32]
    float* dys = tbuf + 2 * SWEEP_ROWS * CT;       // [r][c]
    float* dyt = dys + SWEEP_ROWS * CT;            // [c][DYT_LD]
    float* red = dyt + CT * DYT_LD;                // [16]

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const long long T = (D + CT - 1) / CT;
    const long long lo = (long long)blockIdx.x * T / gridDim.x;
    const long long hi = (long long)(blockIdx.x + 1) * T / gridDim.x;
    const float bc1 = scal[0], bc2 = scal[1], lr = scal[2], decay = scal[3];
    const int kc = warp * 32;  // the 32-wide chunk of d_in this warp's dW and dh cover
    const bool has_chunk = kc < K4;

    for (int e = tid; e < SWEEP_ROWS * K4; e += SWEEP_THREADS) {
        const int r = e / K4, k = e % K4;
        hs[e] = (r < n && k < K) ? h[(size_t)r * K + k] : 0.f;
    }
    copy_tile(w, t, n, K, K4, D, lo * CT, wbuf, tbuf);

    float dh[SWEEP_ROWS];
#pragma unroll
    for (int r = 0; r < SWEEP_ROWS; ++r) dh[r] = 0.f;
    float loss = 0.f;

    for (long long tile = lo; tile < hi; ++tile) {
        const int buf = (int)((tile - lo) & 1);
        const float* ws = wbuf + (size_t)buf * K4 * WLD;
        const float* ts = tbuf + buf * SWEEP_ROWS * CT;
        const long long c0 = tile * CT;
        cp_async_wait_all();
        __syncthreads();  // this tile is in; every thread is done with the other buffer
        if (tile + 1 < hi)
            copy_tile(w, t, n, K, K4, D, c0 + CT, wbuf + (size_t)(buf ^ 1) * K4 * WLD,
                      tbuf + (buf ^ 1) * SWEEP_ROWS * CT);

        // logits of rows 2 warp, 2 warp + 1 at column c0 + lane, k in order
        {
            const int r0 = 2 * warp;
            float acc0 = 0.f, acc1 = 0.f;
            for (int k = 0; k < K4; k += 4) {
                const float4 h0 = *reinterpret_cast<const float4*>(hs + r0 * K4 + k);
                const float4 h1 = *reinterpret_cast<const float4*>(hs + (r0 + 1) * K4 + k);
                const float w0 = ws[k * WLD + lane], w1 = ws[(k + 1) * WLD + lane];
                const float w2 = ws[(k + 2) * WLD + lane], w3 = ws[(k + 3) * WLD + lane];
                acc0 = fmaf(h0.x, w0, acc0);
                acc1 = fmaf(h1.x, w0, acc1);
                acc0 = fmaf(h0.y, w1, acc0);
                acc1 = fmaf(h1.y, w1, acc1);
                acc0 = fmaf(h0.z, w2, acc0);
                acc1 = fmaf(h1.z, w2, acc1);
                acc0 = fmaf(h0.w, w3, acc0);
                acc1 = fmaf(h1.w, w3, acc1);
            }
            const long long gc = c0 + lane;
            const float accs[2] = {acc0, acc1};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int r = r0 + i;
                float d = 0.f;
                if (r < n && gc < D) {
                    const float l = accs[i] + b[gc];
                    const float tv = ts[r * CT + lane];
                    loss += bce_term(l, tv);
                    d = 1.f / (1.f + expf(-l)) - tv;
                }
                dys[r * CT + lane] = d;
                dyt[lane * DYT_LD + r] = d;
            }
        }
        __syncthreads();

        // db and its AdamW: warp 0, a lane a column, rows in order
        if (warp == 0 && c0 + lane < D) {
            const long long gc = c0 + lane;
            float g = 0.f;
            for (int r = 0; r < n; ++r) g += dys[r * CT + lane];
            float p = b[gc], m = mb[gc], v = vb[gc];
            adamw(p, m, v, g, bc1, bc2, lr, decay);
            nb[gc] = p;
            nmb[gc] = m;
            nvb[gc] = v;
        }
        if (!has_chunk) continue;

        // dW of rows kc..kc+31 of d_in at column c0 + lane (rows of the batch
        // in order), then their AdamW from the pre-update W in shared memory
        if (c0 + lane < D) {
            float acc[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[i] = 0.f;
            for (int r = 0; r < SWEEP_ROWS; ++r) {
                const float dv = dys[r * CT + lane];
                const float* hrow = hs + r * K4 + kc;
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    const float4 hv = *reinterpret_cast<const float4*>(hrow + 4 * q);
                    acc[4 * q] = fmaf(hv.x, dv, acc[4 * q]);
                    acc[4 * q + 1] = fmaf(hv.y, dv, acc[4 * q + 1]);
                    acc[4 * q + 2] = fmaf(hv.z, dv, acc[4 * q + 2]);
                    acc[4 * q + 3] = fmaf(hv.w, dv, acc[4 * q + 3]);
                }
            }
            const long long gc = c0 + lane;
#pragma unroll
            for (int q = 0; q < 32; q += 8) {
                float m[8], v[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) {  // eight loads in flight before their use
                    const int k = kc + q + i;
                    const size_t idx = (size_t)(k < K ? k : 0) * D + gc;
                    m[i] = mw[idx];
                    v[i] = vw[idx];
                }
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int k = kc + q + i;
                    if (k < K) {
                        const size_t idx = (size_t)k * D + gc;
                        float p = ws[k * WLD + lane];
                        adamw(p, m[i], v[i], acc[q + i], bc1, bc2, lr, decay);
                        nw[idx] = p;
                        nmw[idx] = m[i];
                        nvw[idx] = v[i];
                    }
                }
            }
        }

        // dh[r][kc + lane] += the tile's columns c of dy[r][c] W[kc + lane][c]
        const float* wrow = ws + (kc + lane) * WLD;
        for (int c = 0; c < CT; ++c) {
            const float wv = wrow[c];
            const float* dcol = dyt + c * DYT_LD;
#pragma unroll
            for (int q = 0; q < SWEEP_ROWS / 4; ++q) {
                const float4 dv = *reinterpret_cast<const float4*>(dcol + 4 * q);
                dh[4 * q] = fmaf(dv.x, wv, dh[4 * q]);
                dh[4 * q + 1] = fmaf(dv.y, wv, dh[4 * q + 1]);
                dh[4 * q + 2] = fmaf(dv.z, wv, dh[4 * q + 2]);
                dh[4 * q + 3] = fmaf(dv.w, wv, dh[4 * q + 3]);
            }
        }
    }

    // the block's dh partial and its loss: warp sums, then the 16 in order
    if (has_chunk && kc + lane < K) {
        float* out = partial + (size_t)blockIdx.x * n * K + kc + lane;
#pragma unroll
        for (int r = 0; r < SWEEP_ROWS; ++r)
            if (r < n) out[(size_t)r * K] = dh[r];
    }
    loss = warp_sum(loss);
    if (lane == 0) red[warp] = loss;
    __syncthreads();
    if (tid == 0) {
        float s = 0.f;
        for (int i = 0; i < SWEEP_THREADS / 32; ++i) s += red[i];
        loss_part[blockIdx.x] = s;
    }
}

bool one_sweep(int n, int K) { return n <= SWEEP_ROWS && K <= SWEEP_MAX_K; }

int one_sweep_blocks(long long D) {
    const long long tiles = (D + CT - 1) / CT;
    return (int)(tiles < SWEEP_BLOCKS ? tiles : SWEEP_BLOCKS);
}

struct Plan {
    int sweep_blocks, k_tiles, r_tiles, P;
    long long chunk, dy_floats, partial_floats;
    size_t sweep_smem;
};

Plan plan(int n, int K, long long D) {
    Plan p;
    p.sweep_blocks = (int)((D + TC - 1) / TC);
    p.k_tiles = (K + 63) / 64;
    p.r_tiles = (n + 63) / 64;
    const long long tiles = (long long)p.k_tiles * p.r_tiles;
    long long want = (TARGET_BLOCKS + tiles - 1) / tiles;
    const long long max_p = (D + DC - 1) / DC;
    if (want > max_p) want = max_p;
    if (want < 1) want = 1;
    const long long per = (D + want - 1) / want;
    p.chunk = (per + DC - 1) / DC * DC;
    p.P = (int)((D + p.chunk - 1) / p.chunk);
    p.dy_floats = (long long)n * D;
    p.partial_floats = (long long)p.P * n * K;
    const int n_pad = (n + RB - 1) / RB * RB;
    p.sweep_smem = sizeof(float) * ((size_t)TILE_T + KC * TC + (size_t)n_pad * TC);
    return p;
}

}  // namespace

extern "C" {

const char* fused_wide_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The most batch rows one call takes: dy of a tile (n_pad x 64 floats) sits
// in shared memory beside the staging tiles, within the 227 KB a block may use.
int fused_wide_max_rows() {
    const size_t rest = sizeof(float) * ((size_t)TILE_T + KC * TC);
    return (int)((232448 - rest) / (sizeof(float) * TC)) / RB * RB;
}

// Floats of device workspace one call needs: in one sweep, a dh partial
// (n x K) and a loss partial per block; else dy (n x D), the dh partials,
// and one loss partial per sweep block.
long long fused_wide_workspace_floats(int n, int K, long long D) {
    if (one_sweep(n, K)) return (long long)one_sweep_blocks(D) * ((long long)n * K + 1);
    const Plan p = plan(n, K, D);
    return p.dy_floats + p.partial_floats + p.sweep_blocks;
}

// Launches one call makes: 2 in one sweep, else 3.
int fused_wide_launches(int n, int K) { return one_sweep(n, K) ? 2 : 3; }

// h: n x K; t: n x D; w, mw, vw: K x D; b, mb, vb: D; scal: 4 floats on the
// device (bc1, bc2, lr, 1 - lr * wd). Outputs: nw, nmw, nvw (K x D), nb,
// nmb, nvb (D), dh (n x K), loss (1 float). All fp32, row-major, contiguous;
// outputs must not alias inputs.
int fused_wide_output_step(const float* h, const float* t, const float* w, const float* b,
                           const float* mw, const float* vw, const float* mb, const float* vb,
                           const float* scal, int n, int K, long long D, float* nw, float* nb,
                           float* nmw, float* nvw, float* nmb, float* nvb, float* dh, float* loss,
                           float* work, void* stream) {
    if (n < 1 || K < 1 || D < 1 || n > fused_wide_max_rows()) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const long long nk = (long long)n * K;
    if (one_sweep(n, K)) {
        const int G = one_sweep_blocks(D);
        const size_t bytes = sizeof(float) * one_sweep_floats((K + 3) & ~3);
        float* partial = work;
        float* loss_part = partial + (size_t)G * nk;
        cudaError_t err = cudaFuncSetAttribute(wide_one_sweep_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bytes);
        if (err != cudaSuccess) return (int)err;
        wide_one_sweep_kernel<<<G, SWEEP_THREADS, bytes, st>>>(
            h, t, w, b, mw, vw, mb, vb, scal, n, K, D, nw, nb, nmw, nvw, nmb, nvb, partial,
            loss_part);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        wide_reduce_kernel<<<(int)((nk + THREADS - 1) / THREADS) + 1, THREADS, 0, st>>>(
            partial, G, nk, loss_part, G, dh, loss);
        return (int)cudaGetLastError();
    }
    const Plan p = plan(n, K, D);
    float* dy = work;
    float* partial = dy + p.dy_floats;
    float* loss_part = partial + p.partial_floats;
    cudaError_t err = cudaFuncSetAttribute(wide_sweep_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)p.sweep_smem);
    if (err != cudaSuccess) return (int)err;
    wide_sweep_kernel<<<p.sweep_blocks, THREADS, p.sweep_smem, st>>>(
        h, t, w, b, mw, vw, mb, vb, scal, n, K, D, nw, nb, nmw, nvw, nmb, nvb, dy, loss_part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wide_dh_partial_kernel<<<dim3(p.k_tiles, p.r_tiles, p.P), THREADS, 0, st>>>(
        dy, w, n, K, D, p.chunk, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int reduce_blocks = (int)((nk + THREADS - 1) / THREADS) + 1;
    wide_reduce_kernel<<<reduce_blocks, THREADS, 0, st>>>(partial, p.P, nk, loss_part,
                                                          p.sweep_blocks, dh, loss);
    return (int)cudaGetLastError();
}

}  // extern "C"
