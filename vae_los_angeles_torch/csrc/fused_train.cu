// Directional-VAE training steps and whole epochs, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels
//   * rna2dna_step_graph_create (the step rna2dna_train_step, a CUDA graph)
//                         <- vae_los_angeles_tpu/ops/pallas/fused_train.py
//                            _train_kernel / _train_step_call (rna2dna_fused_train_step)
//   * rna2dna_epoch_graph_create (the epoch rna2dna_train_epoch, a CUDA graph)
//                         <- vae_los_angeles_tpu/ops/pallas/fused_epoch.py
//                            _epoch_kernel / _epoch_call (rna2dna_fused_epoch)
//   * dna2rna_step_graph_create (the step dna2rna_train_step, a CUDA graph)
//                         <- fused_train.py _d2r_train_kernel / _d2r_train_step_call
//                            (dna2rna_fused_train_step)
//   * dna2rna_epoch_graph_create (dna2rna_train_epoch)
//                         <- fused_epoch.py _d2r_epoch_kernel / _d2r_epoch_call
//                            (dna2rna_fused_epoch)
//
// One RNA->DNA step computes what the TPU kernel computes: the train-mode
// forward (Linear -> batch-statistics BatchNorm -> ReLU -> dropout(0.1) ->
// mu/logvar heads; the site embedding's heads; arithmetic-mean fusion; z = mu
// + eps * exp(logvar / 2); decoder latent -> d1 -> d2 -> out logits), the loss
// BCE-with-logits sum + beta * KLD, the hand-derived gradients of all 19
// tensors of PARAM_ORDER (ops/kernels/fused_train.py) and the BatchNorm
// running statistics (biased variance to normalise, unbiased to track,
// momentum 0.1). A DNA->RNA step (namespace d2r below) does the same for
// EncoderB's two such blocks (512 and 256 wide), DecoderA (latent -> 128 ->
// out, linear) and the loss MSE sum + beta * KLD: the 21 tensors of
// PARAM_ORDER_D2R and both BatchNorms' statistics. An epoch runs n_batches
// such steps, each followed by the torch-order AdamW update (decay first,
// bias correction at step0 + i + 1) of one flat buffer holding all the
// tensors of p, m and v.
//
// What bounds it on an H100: a step at B = 32 is ~166 MFLOP (RNA->DNA) or
// ~136 MFLOP (DNA->RNA) of fp32 against ~7.6 MB of parameters in and
// gradients out, so ~2-2.5 us of FMA at 67 TFLOP/s and ~2.3 us of memory at
// 3.35 TB/s. What the simple design below actually pays is latency: 18
// dependent launches a step, AdamW included, with the parameters and
// moments (11 MB) resident in the 50 MB L2 (times on the card in PERF.md).
//
// The design (simple and deterministic first):
//   * Every product is one strided tile kernel (`gemm_kernel`, 32 x 32 output
//     tiles, 256 threads, 2 x 2 outputs a thread) that reads A(i, k) and
//     B(k, j) through two strides each, so forward products, dX = dY W^T and
//     dW = A^T dY are the same code. A product with few output tiles splits
//     its reduction index into fixed chunks written to a scratch of partial
//     sums; the next phase adds the partials in a fixed order. No atomics:
//     every run gives the same bits.
//   * Every phase that needs a whole column of the batch gives it to one warp
//     (BatchNorm's statistics and its backward: lanes over the rows, sums by
//     butterfly shuffles, which leave the same bits in every lane) or one
//     thread (bias gradients), so no reduction crosses blocks. The posterior
//     and its backward give each (row, latent) output a warp the same way.
//     DNA->RNA's first BN block takes its upstream gradient da2 . W2^T from
//     a split-K product's partials (bn_backward_kernel).
//   * The loss is summed per block in a fixed tree, then by one block over
//     the block sums.
//   * The embedding gradient (the TPU computes one_hot^T . de) gives one
//     thread one (site, column) cell and adds the rows with that site in row
//     order; a label outside [0, sites) matches no cell and gathers a zero
//     row, as the one-hot does.
//   * Noise: NOISE_INJECTED reads the caller's eps (B, latent) and dropout
//     masks; NOISE_PHILOX draws them from Philox4x32-10 keyed by the 64-bit
//     seed, with the counter (row, column, step, stream): stream 0 for the
//     (first) dropout layer, 2 for DNA->RNA's second (keep iff a 24-bit
//     uniform < 0.9), 1 for eps (Box-Muller).
//   * Every epoch (RNA->DNA, DNA->RNA, tri-modal) is a CUDA graph: each
//     step's phases and the AdamW kernel are captured once
//     (*_epoch_graph_create, capture), the wrapper caches the graph with
//     the buffers it addresses, and an epoch is one graph launch
//     (epoch_graph_launch). What changes between epochs (seed, beta, gamma,
//     lr, wd, each step's bias corrections) is read on the card from an
//     EpochArgs buffer; the Philox step index and the row offsets stay baked.
//     A directional step is 18 launches with its AdamW (17 phases; 24 as
//     host-loop launches), a tri-modal one 22 (21 phases):
//     a phase's independent products and column sums go out as one
//     gemm_group_kernel, independent BatchNorms, heads and heads' backwards
//     as one launch each, and the BatchNorm backward that reads only dmh and
//     dlh shares one launch with the heads' gradients.
//   * Every train step (RNA->DNA, DNA->RNA, tri-modal) is a CUDA graph too
//     (*_step_graph_create), one graph serving every step of a shape: what
//     changes between calls (seed, beta, gamma and the Philox step index) is
//     a StepArgs that the graph's first node (step_args_kernel) writes to the
//     card, its arguments set before each launch (step_graph_launch); a call
//     is one graph launch of 18 (directional) or 22 (tri-modal) kernels.
//   * Inside the step graphs and the tri-modal epoch the phases launch
//     programmatically (PDL, struct Queue): the next phase is scheduled
//     while the previous one drains, and in a step graph a product fetches
//     its first tile of a weight operand before it waits for the previous
//     phase's activations. The directional epochs launch plainly (PDL took
//     them 1-3% slower).
//
// Plain C interface, built with nvcc into a shared library and called through
// ctypes (ops/kernels/_build.py, fused_train.py, fused_epoch.py). Every entry
// point launches on the caller's stream, allocates nothing, and returns the
// first CUDA error (cudaGetLastError after each launch).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float BN_EPS = 1e-5f;
constexpr float BN_MOMENTUM = 0.1f;
constexpr float KEEP = 0.9f;  // 1 - DROPOUT_RATE
constexpr float ADAM_B1 = 0.9f;
constexpr float ADAM_B2 = 0.999f;
constexpr float ADAM_EPS = 1e-8f;
constexpr int TILE = 32;           // gemm output tile and reduction step
constexpr int GEMM_THREADS = 256;
constexpr int SPLIT_TARGET = 128;  // blocks a split-K product aims for (fixed: same bits on any card)
constexpr int MAX_CHUNK_TILES = 32;  // longest split-K chunk of a wide reduction (1,024 of K)
constexpr int WIDE_K_TILES = 64;     // a reduction longer than 2,048 is a wide layer's
constexpr int LOSS_BLOCKS = 64;
constexpr int THREADS = 256;

enum NoiseMode { NOISE_INJECTED = 0, NOISE_PHILOX = 1 };

// What changes from one tri-modal epoch to the next, read on the card: the
// captured epoch (a CUDA graph, which replays its launches with their
// arguments as captured) takes these from this buffer rather than from
// kernel arguments. The bias corrections (bc1, bc2) of step i follow the
// struct at floats [2i, 2i + 1]. A null pointer means "use the kernel's own
// arguments" (the step entries and the directional epochs).
struct EpochArgs {
    unsigned long long seed;
    float beta, gamma, lr, wd;
};
static_assert(sizeof(EpochArgs) == 24, "EpochArgs is 6 floats: the wrapper packs it so");

__device__ __forceinline__ const float* epoch_bc(const EpochArgs* ea) {
    return reinterpret_cast<const float*>(ea + 1);
}

// A step graph's args (one graph serves every step): the EpochArgs fields a
// step reads (seed, beta, gamma; lr and wd unused) and the step's Philox
// index, which the epoch graphs bake into their launches and a step graph
// cannot. The wrapper packs it (fused_train.step_args); step_args_kernel, the
// graph's first node, writes it to the device buffer the phases read, and
// step_graph_launch sets that node's arguments before each launch.
struct StepArgs {
    EpochArgs e;
    int step;
    int pad;
};
static_assert(sizeof(StepArgs) == 32, "StepArgs is 8 floats: the wrapper packs it so");

__global__ void step_args_kernel(StepArgs a, StepArgs* dst) { *dst = a; }

// The Philox step index of a phase: read on the card from a step graph's
// args (``step_at``), else the launch's own argument.
__device__ __forceinline__ int step_index(const int* step_at, int step) {
    return step_at ? *step_at : step;
}

// Programmatic dependent launch (Hopper). A phase launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may be scheduled once
// every block of the phase before it has exited, before that phase's writes
// are flushed: it may read what no phase of its graph writes (a step graph's
// parameters), then waits until the previous phase has completed and its
// writes are visible (pdl_wait) before it reads or writes anything else.
// Every block of every phase waits, so the wait is transitive: a phase that
// passed its wait sees every earlier phase's writes. No phase triggers its
// dependents early: an explicit trigger at each phase's start measured slower
// in every epoch, and one after a product's loop no faster than the implicit
// one at exit. A phase's <false> instance (plain launches) does not wait.
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_all;" ::: "memory");
}
enum Stream { STREAM_DROPOUT = 0, STREAM_EPS = 1, STREAM_DROPOUT2 = 2, STREAM_DROPOUT3 = 3 };
enum Epilogue { EPI_BIAS_RELU = 0, EPI_RELU_MASK = 1 };

// PARAM_ORDER of ops/kernels/fused_train.py, JAX layout: a Linear's weight
// is (in, out) row-major.
enum Param {
    W1, B1, GAMMA, BNBETA, WMU, BMU, WLV, BLV, EMB, SMU_W, SMU_B, SLV_W, SLV_B,
    D1W, D1B, D2W, D2B, D3W, D3B, N_PARAMS
};

struct Dims {
    int in, hid, latent, sites, embed, d1, d2, out;
};

void param_sizes(const Dims& d, long long* s) {
    s[W1] = (long long)d.in * d.hid; s[B1] = d.hid; s[GAMMA] = d.hid; s[BNBETA] = d.hid;
    s[WMU] = (long long)d.hid * d.latent; s[BMU] = d.latent;
    s[WLV] = (long long)d.hid * d.latent; s[BLV] = d.latent;
    s[EMB] = (long long)d.sites * d.embed;
    s[SMU_W] = (long long)d.embed * d.latent; s[SMU_B] = d.latent;
    s[SLV_W] = (long long)d.embed * d.latent; s[SLV_B] = d.latent;
    s[D1W] = (long long)d.latent * d.d1; s[D1B] = d.d1;
    s[D2W] = (long long)d.d1 * d.d2; s[D2B] = d.d2;
    s[D3W] = (long long)d.d2 * d.out; s[D3B] = d.out;
}

long long param_offsets(const Dims& d, long long* off) {
    long long s[N_PARAMS];
    param_sizes(d, s);
    long long total = 0;
    for (int i = 0; i < N_PARAMS; ++i) {
        off[i] = total;
        total += s[i];
    }
    return total;
}

// ---------------------------------------------------------------------------
// Philox4x32-10 (Salmon et al., SC'11), as in fused_vae.cu.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
        const uint32_t lo0 = 0xD2511F53u * c.x;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
        const uint32_t lo1 = 0xCD9E8D57u * c.z;
        c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
        k.x += 0x9E3779B9u;
        k.y += 0xBB67AE85u;
    }
    return c;
}

__device__ __forceinline__ uint4 philox_bits(uint64_t seed, int row, int col, int step, int stream) {
    return philox4x32_10(make_uint4((uint32_t)row, (uint32_t)col, (uint32_t)step, (uint32_t)stream),
                         make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)));
}

// Dropout keep flag of (row, column) at a step: a 24-bit uniform < 0.9.
// Each dropout layer draws from a stream of its own.
__device__ __forceinline__ float philox_keep(uint64_t seed, int row, int col, int step,
                                             int stream) {
    const uint32_t bits = philox_bits(seed, row, col, step, stream).x;
    return ((float)(bits >> 8) * (1.0f / 16777216.0f)) < KEEP ? 1.f : 0.f;
}

// Standard normal of (row, latent index) at a step: Box-Muller on two
// (0, 1] uniforms from the top 24 bits of two Philox words.
__device__ __forceinline__ float philox_normal(uint64_t seed, int row, int col, int step) {
    const uint4 bits = philox_bits(seed, row, col, step, STREAM_EPS);
    const float u1 = (float)((bits.x >> 8) + 1u) * (1.0f / 16777216.0f);
    const float u2 = (float)((bits.y >> 8) + 1u) * (1.0f / 16777216.0f);
    return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

// ---------------------------------------------------------------------------
// C[z][i][j] = sum over k in chunk z of A(i, k) * B(k, j), with
// A(i, k) = a[i * a0 + k * a1] and B(k, j) = b[k * b0 + j * b1]. Grid
// (ceil(N / 32), ceil(M / 32), splits); chunk z covers k in
// [z * kchunk, min(K, (z + 1) * kchunk)). Loads run along whichever index is
// contiguous, so global reads coalesce for either layout.

// The FMA of one 32-deep step of a tile (gemm_tile).
__device__ __forceinline__ void tile_fma(const float (&As)[TILE][TILE + 1],
                                         const float (&Bs)[TILE][TILE + 1], int tx, int ty,
                                         float& acc00, float& acc01, float& acc10, float& acc11) {
#pragma unroll 8
    for (int kk = 0; kk < TILE; ++kk) {
        const float x0 = As[kk][ty], x1 = As[kk][ty + 16];
        const float y0 = Bs[kk][tx], y1 = Bs[kk][tx + 16];
        acc00 = fmaf(x0, y0, acc00);
        acc01 = fmaf(x0, y1, acc01);
        acc10 = fmaf(x1, y0, acc10);
        acc11 = fmaf(x1, y1, acc11);
    }
}

// One output tile (bx, by) of chunk bz; with ``bias`` (a product that is not
// split) the tile is written through bias + ReLU. In the PDL instance, with
// ``b_early`` (B is a parameter of a step graph, which no phase writes) the
// first B tile is fetched by cp.async before the phase waits for the
// previous one; the <false> instance is the plain launches' loop.
template <bool PDL>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ a, int a0, int a1,
                                          const float* __restrict__ b, int b0, int b1,
                                          float* __restrict__ c, int M, int N, int K, int kchunk,
                                          const float* __restrict__ bias, int b_early, int bx,
                                          int by, int bz) {
    __shared__ float As[TILE][TILE + 1];  // As[k][i]
    __shared__ float Bs[TILE][TILE + 1];  // Bs[k][j]
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int i0 = by * TILE, j0 = bx * TILE;
    const int kbeg = bz * kchunk;
    const int kend = min(K, kbeg + kchunk);
    float acc00 = 0.f, acc01 = 0.f, acc10 = 0.f, acc11 = 0.f;
    int k0 = kbeg;
    if constexpr (PDL) {
        if (b_early && k0 < kend) {  // the first B tile in flight while the previous phase drains
            for (int idx = tid; idx < TILE * TILE; idx += GEMM_THREADS) {
                const int p = idx & (TILE - 1), q = idx >> 5;
                const int bj = b1 == 1 ? p : q, bk = b1 == 1 ? q : p;
                const int gj = j0 + bj, gk2 = k0 + bk;
                if (gj < N && gk2 < kend) {
                    cp_async4(&Bs[bk][bj], b + (size_t)gk2 * b0 + (size_t)gj * b1);
                } else {
                    Bs[bk][bj] = 0.f;
                }
            }
            pdl_wait();
            for (int idx = tid; idx < TILE * TILE; idx += GEMM_THREADS) {
                const int p = idx & (TILE - 1), q = idx >> 5;
                const int ai = a1 == 1 ? q : p, ak = a1 == 1 ? p : q;
                const int gi = i0 + ai, gk = k0 + ak;
                As[ak][ai] = (gi < M && gk < kend) ? a[(size_t)gi * a0 + (size_t)gk * a1] : 0.f;
            }
            cp_async_wait_all();
            __syncthreads();
            tile_fma(As, Bs, tx, ty, acc00, acc01, acc10, acc11);
            __syncthreads();
            k0 += TILE;
        } else {
            pdl_wait();
        }
    }
    for (; k0 < kend; k0 += TILE) {
        for (int idx = tid; idx < TILE * TILE; idx += GEMM_THREADS) {
            const int p = idx & (TILE - 1), q = idx >> 5;
            // A: contiguous along k when a1 == 1
            const int ai = a1 == 1 ? q : p, ak = a1 == 1 ? p : q;
            const int gi = i0 + ai, gk = k0 + ak;
            As[ak][ai] = (gi < M && gk < kend) ? a[(size_t)gi * a0 + (size_t)gk * a1] : 0.f;
            // B: contiguous along j when b1 == 1
            const int bj = b1 == 1 ? p : q, bk = b1 == 1 ? q : p;
            const int gj = j0 + bj, gk2 = k0 + bk;
            Bs[bk][bj] = (gj < N && gk2 < kend) ? b[(size_t)gk2 * b0 + (size_t)gj * b1] : 0.f;
        }
        __syncthreads();
        tile_fma(As, Bs, tx, ty, acc00, acc01, acc10, acc11);
        __syncthreads();
    }
    float* cz = c + (size_t)bz * M * N;
    const int ia = i0 + ty, ib = i0 + ty + 16, ja = j0 + tx, jb = j0 + tx + 16;
    if (bias) {  // as epilogue_kernel's EPI_BIAS_RELU over one partial
        if (ja < N) {
            acc00 = fmaxf((0.f + acc00) + bias[ja], 0.f);
            acc10 = fmaxf((0.f + acc10) + bias[ja], 0.f);
        }
        if (jb < N) {
            acc01 = fmaxf((0.f + acc01) + bias[jb], 0.f);
            acc11 = fmaxf((0.f + acc11) + bias[jb], 0.f);
        }
    }
    if (ia < M && ja < N) cz[(size_t)ia * N + ja] = acc00;
    if (ia < M && jb < N) cz[(size_t)ia * N + jb] = acc01;
    if (ib < M && ja < N) cz[(size_t)ib * N + ja] = acc10;
    if (ib < M && jb < N) cz[(size_t)ib * N + jb] = acc11;
}

template <bool PDL>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const float* __restrict__ a, int a0, int a1, const float* __restrict__ b, int b0,
            int b1, float* __restrict__ c, int M, int N, int K, int kchunk, int b_early) {
    gemm_tile<PDL>(a, a0, a1, b, b0, b1, c, M, N, K, kchunk, nullptr, b_early, blockIdx.x,
                   blockIdx.y, blockIdx.z);
}

struct Split {
    int splits, kchunk;
};

// Fixed split of the reduction index: enough blocks for the card, chunks of
// whole 32-wide steps, and, for a reduction longer than WIDE_K_TILES steps,
// no chunk longer than MAX_CHUNK_TILES steps (a chunk is summed in one
// thread's registers: a reduction over a wide layer, K = 65,536 or 262,144,
// in 8 chunks ran 128 blocks of up to 32,768 sequential FMAs each, slow and
// further from a float64 sum than cuBLAS). Depends on the shapes only. No K
// at the cohort's widths (at most 1,211, or the batch) is that long, so there
// the split is SPLIT_TARGET's alone.
Split split_for(int M, int N, int K, int max_splits) {
    const int tiles = ((M + TILE - 1) / TILE) * ((N + TILE - 1) / TILE);
    const int ktiles = (K + TILE - 1) / TILE;
    int want = (SPLIT_TARGET + tiles - 1) / tiles;
    const int by_length = (ktiles + MAX_CHUNK_TILES - 1) / MAX_CHUNK_TILES;
    if (ktiles > WIDE_K_TILES && want < by_length) want = by_length;
    if (want > ktiles) want = ktiles;
    if (want > max_splits) want = max_splits;
    if (want < 1) want = 1;
    const int per = (ktiles + want - 1) / want;
    return Split{(ktiles + per - 1) / per, per * TILE};
}

struct Mat {
    const float* p;
    int s0, s1;
};

// Where and how a step's phases launch: with ``pdl`` (the step graphs, the
// tri-modal epoch) each with the programmatic-serialization attribute,
// waiting before it touches anything, else as plain stream launches (the
// directional epochs). A
// product may fetch its first tile of a B operand that lies in [lo, hi)
// before it waits: a step graph's parameter buffer, which no phase of the
// graph writes (an epoch's AdamW writes its parameters: null there).
struct Queue {
    cudaStream_t st;
    bool pdl;
    const float *lo = nullptr, *hi = nullptr;

    int early(const float* p) const { return pdl && p >= lo && p < hi; }
};

// One phase launch on ``q``; returns its CUDA error.
template <class... Params, class... Args>
int launch_phase(const Queue& q, void (*kernel)(Params...), dim3 grid, int threads,
                 Args... args) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.stream = q.st;
    cfg.attrs = attr;
    cfg.numAttrs = q.pdl ? 1 : 0;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}

// A phase kernel is a template on PDL: its <false> instance is the code of
// plain stream launches, without the waits, triggers or early fetches, and
// runs wherever the queue launches without the attribute.
#define LAUNCH(q, kernel, grid, threads, ...)                                           \
    ((q).pdl ? launch_phase(q, kernel<true>, grid, threads, __VA_ARGS__) \
             : launch_phase(q, kernel<false>, grid, threads, __VA_ARGS__))

int gemm(Mat A, Mat B, float* C, int M, int N, int K, int max_splits, const Queue& q,
         int* splits_out) {
    const Split s = split_for(M, N, K, max_splits);
    const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE, s.splits);
    if (splits_out) *splits_out = s.splits;
    return LAUNCH(q, gemm_kernel, grid, GEMM_THREADS, A.p, A.s0, A.s1, B.p, B.s0, B.s1, C, M, N,
                  K, s.kchunk, q.early(B.p));
}

__device__ __forceinline__ float sum_splits(const float* __restrict__ part, int splits, size_t mn,
                                            size_t idx) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += part[(size_t)z * mn + idx];
    return acc;
}

// ---------------------------------------------------------------------------
// Sum of a value over the 32 lanes of a warp by butterfly shuffles: every
// lane ends with the same bits (each addition is commutative), so results
// do not depend on the lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

constexpr int WARPS = THREADS / 32;

// One encoder BatchNorm (train mode), ReLU and dropout: its partial sums,
// parameters, statistics, noise and outputs, in the order bn_forward takes
// them. ``stream`` is the dropout layer's Philox stream.
struct BnForward {
    const float* part;
    int splits, B, H;
    const float *b1, *gamma, *beta, *rm_in, *rv_in;
    float *rm_out, *rv_out;
    const float* drop_in;
    int noise;
    uint64_t seed;
    const EpochArgs* ea;
    int step;
    const int* step_at;
    int stream;
    float *xhat, *dcoef, *d, *inv_std;
};

// Column ``j`` of one BatchNorm forward, its lanes over the rows.
__device__ __forceinline__ void bn_forward_col(const BnForward& f, int j, int lane) {
    if (j >= f.H) return;  // warp-uniform
    const size_t mn = (size_t)f.B * f.H;
    float sum = 0.f;
    for (int r = lane; r < f.B; r += 32) {
        const float a = sum_splits(f.part, f.splits, mn, (size_t)r * f.H + j) + f.b1[j];
        f.xhat[(size_t)r * f.H + j] = a;  // a1 for now
        sum += a;
    }
    const float mean = warp_sum(sum) / (float)f.B;
    float sq = 0.f;
    for (int r = lane; r < f.B; r += 32) {
        const float c = f.xhat[(size_t)r * f.H + j] - mean;
        sq += c * c;
    }
    const float var = warp_sum(sq) / (float)f.B;
    const float inv = rsqrtf(var + BN_EPS);
    const float g = f.gamma[j], bb = f.beta[j];
    const uint64_t sd = f.ea ? f.ea->seed : f.seed;
    const int stp = step_index(f.step_at, f.step);
    for (int r = lane; r < f.B; r += 32) {
        const size_t i = (size_t)r * f.H + j;
        const float xh = (f.xhat[i] - mean) * inv;
        const float h = xh * g + bb;
        const float keep = f.noise == NOISE_PHILOX ? philox_keep(sd, r, j, stp, f.stream)
                                                   : f.drop_in[i];
        const float coef = h > 0.f ? keep / KEEP : 0.f;
        f.xhat[i] = xh;
        f.dcoef[i] = coef;
        f.d[i] = h * coef;
    }
    if (lane == 0) {
        f.inv_std[j] = inv;
        const float unbias = (float)f.B / (float)(f.B > 1 ? f.B - 1 : 1);
        f.rm_out[j] = (1.0f - BN_MOMENTUM) * f.rm_in[j] + BN_MOMENTUM * mean;
        f.rv_out[j] = (1.0f - BN_MOMENTUM) * f.rv_in[j] + BN_MOMENTUM * var * unbias;
    }
}

// Up to two independent BatchNorm forwards in one launch, a warp a column:
// blocks [0, ceil(a.H / WARPS)) take ``a``, the rest ``b`` (H = 0: none).
template <bool PDL>
__global__ void __launch_bounds__(THREADS) bn_forward_kernel(const BnForward a,
                                                             const BnForward b) {
    if constexpr (PDL) pdl_wait();
    const int blocks_a = (a.H + WARPS - 1) / WARPS;
    const int lane = threadIdx.x & 31;
    if ((int)blockIdx.x < blocks_a) {
        bn_forward_col(a, blockIdx.x * WARPS + (threadIdx.x >> 5), lane);
    } else {
        bn_forward_col(b, (blockIdx.x - blocks_a) * WARPS + (threadIdx.x >> 5), lane);
    }
}

struct Heads {
    const float *wmu, *bmu, *wlv, *blv, *emb, *smu_w, *smu_b, *slv_w, *slv_b;
};

// Posterior heads, site gather, fusion and z: one warp per (row, latent
// index), its lanes over the heads' input index; the grid's threads also
// store the gathered embedding rows.
template <bool PDL>
__global__ void __launch_bounds__(THREADS)
posterior_kernel(const float* __restrict__ d, const int64_t* __restrict__ site, Heads w,
                 int B, int H, int L, int S, int E, const float* __restrict__ eps_in, int noise,
                 uint64_t seed, const EpochArgs* ea, int step, const int* step_at,
                 float* __restrict__ e,
                 float* __restrict__ mu,
                 float* __restrict__ lv, float* __restrict__ epsv, float* __restrict__ sigma,
                 float* __restrict__ z) {
    if constexpr (PDL) pdl_wait();
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    for (int idx = tid; idx < B * E; idx += gridDim.x * blockDim.x) {
        const int r = idx / E, c = idx - r * E;
        const int64_t s = site[r];
        e[idx] = (s >= 0 && s < S) ? w.emb[s * E + c] : 0.f;
    }
    const int idx = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (idx >= B * L) return;  // warp-uniform
    const int r = idx / L, j = idx - r * L;
    float mr = 0.f, lr = 0.f;
    for (int k = lane; k < H; k += 32) {
        const float dv = d[(size_t)r * H + k];
        mr = fmaf(dv, w.wmu[(size_t)k * L + j], mr);
        lr = fmaf(dv, w.wlv[(size_t)k * L + j], lr);
    }
    const int64_t s = site[r];
    const bool valid = s >= 0 && s < S;
    float ms = 0.f, ls = 0.f;
    for (int c = lane; c < E; c += 32) {
        const float ev = valid ? w.emb[s * E + c] : 0.f;
        ms = fmaf(ev, w.smu_w[(size_t)c * L + j], ms);
        ls = fmaf(ev, w.slv_w[(size_t)c * L + j], ls);
    }
    mr = warp_sum(mr) + w.bmu[j];
    lr = warp_sum(lr) + w.blv[j];
    ms = warp_sum(ms) + w.smu_b[j];
    ls = warp_sum(ls) + w.slv_b[j];
    if (lane != 0) return;
    const float m = 0.5f * (mr + ms);
    const float v = 0.5f * (lr + ls);
    const float ep = noise == NOISE_PHILOX
                         ? philox_normal(ea ? ea->seed : seed, r, j, step_index(step_at, step))
                         : eps_in[idx];
    const float sg = expf(0.5f * v);
    mu[idx] = m;
    lv[idx] = v;
    epsv[idx] = ep;
    sigma[idx] = sg;
    z[idx] = m + ep * sg;
}

// out = relu(sum of partials + bias), or out = sum of partials where ref > 0.
template <bool PDL>
__global__ void epilogue_kernel(const float* __restrict__ part, int splits, int M, int N,
                                const float* __restrict__ bias, const float* __restrict__ ref,
                                float* __restrict__ out, int mode) {
    if constexpr (PDL) pdl_wait();
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t mn = (size_t)M * N;
    if (idx >= mn) return;
    const float acc = sum_splits(part, splits, mn, idx);
    if (mode == EPI_BIAS_RELU) {
        out[idx] = fmaxf(acc + bias[idx % N], 0.f);
    } else {
        out[idx] = ref[idx] > 0.f ? acc : 0.f;
    }
}

// Logits, BCE-with-logits per element, dlogits = sigmoid(l) - t. A fixed
// grid of LOSS_BLOCKS blocks; each writes the sum of its elements' BCE terms
// (a fixed tree over its threads) to part[block].
template <bool PDL>
__global__ void __launch_bounds__(THREADS)
logits_kernel(const float* __restrict__ acc_part, int splits, int B, int O,
              const float* __restrict__ bias, const float* __restrict__ t,
              float* __restrict__ dlogits, float* __restrict__ part) {
    if constexpr (PDL) pdl_wait();
    __shared__ float red[THREADS];
    const size_t mn = (size_t)B * O;
    float bce = 0.f;
    for (size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x; idx < mn;
         idx += (size_t)gridDim.x * THREADS) {
        const float l = sum_splits(acc_part, splits, mn, idx) + bias[idx % O];
        const float tv = t[idx];
        bce += fmaxf(l, 0.f) - l * tv + log1pf(expf(-fabsf(l)));
        dlogits[idx] = 1.0f / (1.0f + expf(-l)) - tv;
    }
    red[threadIdx.x] = bce;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
        __syncthreads();
    }
    if (threadIdx.x == 0) part[blockIdx.x] = red[0];
}

// The DNA->RNA head: recon = sum of partials + bias, diff = recon - t,
// drecon = 2 * diff, and the sum of diff^2 per block (a fixed tree) in
// part[block]. A fixed grid of LOSS_BLOCKS blocks, as logits_kernel.
// Block ``blk`` of the ``nblk`` (LOSS_BLOCKS) that mse_kernel launches.
__device__ __forceinline__ void mse_block(const float* __restrict__ acc_part, int splits, int B,
                                          int O, const float* __restrict__ bias,
                                          const float* __restrict__ t,
                                          float* __restrict__ drecon, float* __restrict__ part,
                                          int blk, int nblk) {
    __shared__ float red[THREADS];
    const size_t mn = (size_t)B * O;
    float sq = 0.f;
    for (size_t idx = (size_t)blk * THREADS + threadIdx.x; idx < mn;
         idx += (size_t)nblk * THREADS) {
        const float diff = (sum_splits(acc_part, splits, mn, idx) + bias[idx % O]) - t[idx];
        sq = fmaf(diff, diff, sq);
        drecon[idx] = 2.0f * diff;
    }
    red[threadIdx.x] = sq;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
        __syncthreads();
    }
    if (threadIdx.x == 0) part[blk] = red[0];
}

template <bool PDL>
__global__ void __launch_bounds__(THREADS)
mse_kernel(const float* __restrict__ acc_part, int splits, int B, int O,
           const float* __restrict__ bias, const float* __restrict__ t,
           float* __restrict__ drecon, float* __restrict__ part) {
    if constexpr (PDL) pdl_wait();
    mse_block(acc_part, splits, B, O, bias, t, drecon, part, blockIdx.x, gridDim.x);
}

// loss = sum of the block sums + beta * KLD, one block.
template <bool PDL>
__global__ void __launch_bounds__(THREADS)
loss_finish_kernel(const float* __restrict__ part, int n_part, const float* __restrict__ mu,
                   const float* __restrict__ lv, int n_lat, float beta, const EpochArgs* ea,
                   float* loss) {
    if constexpr (PDL) pdl_wait();
    __shared__ float rb[THREADS];
    __shared__ float rk[THREADS];
    float b = 0.f, k = 0.f;
    for (int i = threadIdx.x; i < n_part; i += THREADS) b += part[i];
    for (int i = threadIdx.x; i < n_lat; i += THREADS) {
        const float m = mu[i], v = lv[i];
        k += 1.0f + v - m * m - expf(v);
    }
    rb[threadIdx.x] = b;
    rk[threadIdx.x] = k;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) {
            rb[threadIdx.x] += rb[threadIdx.x + s];
            rk[threadIdx.x] += rk[threadIdx.x + s];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) *loss = rb[0] + (ea ? ea->beta : beta) * (-0.5f * rk[0]);
}

// ---------------------------------------------------------------------------
// Independent products (and column sums) of one phase in one launch: each
// block finds its problem from its index and runs the same tile code as
// gemm_kernel (for a column-sum block, a thread a column summing its rows in
// order), so a grouped product gives the bits of the same product launched
// alone.
constexpr int MAX_PRODS = 6;
constexpr int MAX_COLSUMS = 3;

struct GroupProd {
    const float *a, *b, *bias;
    float* c;
    int a0, a1, b0, b1, M, N, K, kchunk, tiles_n, tiles, blocks, b_early;
};

struct GroupColsum {
    const float* y;
    float* out;
    int M, N, blocks;
};

struct GemmGroup {
    GroupProd p[MAX_PRODS];
    GroupColsum cs[MAX_COLSUMS];
    int n_prods, n_colsums;
};

template <bool PDL>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_group_kernel(const GemmGroup g) {
    int blk = blockIdx.x;
#pragma unroll
    for (int q = 0; q < MAX_PRODS; ++q) {
        if (q >= g.n_prods) break;
        const GroupProd& p = g.p[q];
        if (blk < p.blocks) {
            const int z = blk / p.tiles, rem = blk - z * p.tiles;
            const int y = rem / p.tiles_n, x = rem - y * p.tiles_n;
            gemm_tile<PDL>(p.a, p.a0, p.a1, p.b, p.b0, p.b1, p.c, p.M, p.N, p.K, p.kchunk,
                           p.bias, p.b_early, x, y, z);
            return;
        }
        blk -= p.blocks;
    }
#pragma unroll
    for (int q = 0; q < MAX_COLSUMS; ++q) {
        if (q >= g.n_colsums) break;
        const GroupColsum& c = g.cs[q];
        if (blk < c.blocks) {
            if constexpr (PDL) pdl_wait();
            const int j = blk * GEMM_THREADS + threadIdx.x;
            if (j >= c.N) return;
            float s = 0.f;
            for (int r = 0; r < c.M; ++r) s += c.y[(size_t)r * c.N + j];
            c.out[j] = s;
            return;
        }
        blk -= c.blocks;
    }
}

// out = (sum of partials) where ref > 0, else 0 (epilogue_kernel's
// EPI_RELU_MASK), for up to three independent layers in one launch.
constexpr int MAX_EPIS = 3;

struct EpiJob {
    const float *part, *ref;
    float* out;
    int splits, M, N, blocks;
};

struct EpiGroup {
    EpiJob j[MAX_EPIS];
    int n;
};

template <bool PDL>
__global__ void __launch_bounds__(THREADS) relu_mask_group_kernel(const EpiGroup g) {
    if constexpr (PDL) pdl_wait();
    int blk = blockIdx.x;
#pragma unroll
    for (int q = 0; q < MAX_EPIS; ++q) {
        if (q >= g.n) break;
        const EpiJob& e = g.j[q];
        if (blk < e.blocks) {
            const size_t idx = (size_t)blk * THREADS + threadIdx.x;
            const size_t mn = (size_t)e.M * e.N;
            if (idx >= mn) return;
            const float acc = sum_splits(e.part, e.splits, mn, idx);
            e.out[idx] = e.ref[idx] > 0.f ? acc : 0.f;
            return;
        }
        blk -= e.blocks;
    }
}

// dz = du1 . d1w^T, then the posterior's backward: dmu/2 and dlogvar/2
// (each of the two fused posteriors takes half). One warp per (row, j), its
// lanes over d1.
template <bool PDL>
__global__ void __launch_bounds__(THREADS)
posterior_backward_kernel(const float* __restrict__ du1, const float* __restrict__ d1w, int B,
                          int D1, int L, const float* __restrict__ mu,
                          const float* __restrict__ lv, const float* __restrict__ epsv,
                          const float* __restrict__ sigma, float beta, const EpochArgs* ea,
                          float* __restrict__ dmh, float* __restrict__ dlh) {
    if constexpr (PDL) pdl_wait();
    const int idx = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (idx >= B * L) return;  // warp-uniform
    const int r = idx / L, j = idx - r * L;
    if (ea) beta = ea->beta;
    float dz = 0.f;
    for (int k = lane; k < D1; k += 32) dz = fmaf(du1[(size_t)r * D1 + k], d1w[(size_t)j * D1 + k], dz);
    dz = warp_sum(dz);
    if (lane != 0) return;
    const float dmu = dz + beta * mu[idx];
    const float dlv = dz * epsv[idx] * 0.5f * sigma[idx] + (-0.5f * beta) * (1.0f - expf(lv[idx]));
    dmh[idx] = 0.5f * dmu;
    dlh[idx] = 0.5f * dlv;
}

struct HeadGrads {
    float *wmu, *bmu, *wlv, *blv, *smu_w, *smu_b, *slv_w, *slv_b;
};

// Gradients of the four posterior heads: one thread per output element
// (thread ``idx`` of heads_backward_kernel's head part), each summing its B
// rows in order.
__device__ __forceinline__ void head_grad_at(int idx, const float* __restrict__ d,
                                             const float* __restrict__ e,
                                             const float* __restrict__ dmh,
                                             const float* __restrict__ dlh, int B, int H, int E,
                                             int L, const HeadGrads& g) {
    const int HL = H * L, EL = E * L;
    const float* act;
    const float* dy;
    float* out;
    int width, k, j;
    if (idx < 2 * HL) {
        const bool lvh = idx >= HL;
        const int q = lvh ? idx - HL : idx;
        k = q / L; j = q - k * L;
        act = d; width = H; dy = lvh ? dlh : dmh; out = (lvh ? g.wlv : g.wmu) + q;
    } else if ((idx -= 2 * HL) < 2 * EL) {
        const bool lvh = idx >= EL;
        const int q = lvh ? idx - EL : idx;
        k = q / L; j = q - k * L;
        act = e; width = E; dy = lvh ? dlh : dmh; out = (lvh ? g.slv_w : g.smu_w) + q;
    } else if ((idx -= 2 * EL) < 2 * L) {
        const bool lvh = idx >= L;
        j = lvh ? idx - L : idx;
        dy = lvh ? dlh : dmh;
        float s = 0.f;
        for (int r = 0; r < B; ++r) s += dy[(size_t)r * L + j];
        // the encoder's head bias and the site head's bias see the same dy
        (lvh ? g.blv : g.bmu)[j] = s;
        (lvh ? g.slv_b : g.smu_b)[j] = s;
        return;
    } else {
        return;
    }
    float s = 0.f;
    for (int r = 0; r < B; ++r) s = fmaf(act[(size_t)r * width + k], dy[(size_t)r * L + j], s);
    *out = s;
}

// g_emb[s][c] = sum over rows r with site[r] == s of de[r][c], with
// de = dmh . smu_w^T + dlh . slv_w^T computed for the matching rows only;
// one thread (``idx``) a cell.
__device__ __forceinline__ void emb_grad_at(int idx, const int64_t* __restrict__ site,
                                            const float* __restrict__ dmh,
                                            const float* __restrict__ dlh,
                                            const float* __restrict__ smu_w,
                                            const float* __restrict__ slv_w, int B, int S, int E,
                                            int L, float* __restrict__ g_emb) {
    if (idx >= S * E) return;
    const int s = idx / E, c = idx - s * E;
    float acc = 0.f;
    for (int r = 0; r < B; ++r) {
        if (site[r] != s) continue;
        float de = 0.f;
        for (int j = 0; j < L; ++j) {
            de = fmaf(dmh[(size_t)r * L + j], smu_w[(size_t)c * L + j], de);
            de = fmaf(dlh[(size_t)r * L + j], slv_w[(size_t)c * L + j], de);
        }
        acc += de;
    }
    g_emb[idx] = acc;
}

// dd = dmh . wmu^T + dlh . wlv^T (FROM_HEADS; else dd is the sum of the
// split-K partials dd_part of a product), dh = dd * relu mask * dropout /
// keep, and train-mode BatchNorm's backward, one warp per column (column
// ``k``, lane ``lane``), its lanes over the rows: dgamma, dbeta, da1 =
// inv_std * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) and the
// encoder bias gradient sum(da1).
template <bool FROM_HEADS>
__device__ __forceinline__ void bn_backward_col(
    int k, int lane, const float* __restrict__ dmh, const float* __restrict__ dlh,
    const float* __restrict__ wmu, const float* __restrict__ wlv,
    const float* __restrict__ dd_part, int splits, const float* __restrict__ dcoef,
    const float* __restrict__ xhat, const float* __restrict__ inv_std,
    const float* __restrict__ gamma, int B, int H, int L, float* __restrict__ da1,
    float* __restrict__ g_gamma, float* __restrict__ g_beta, float* __restrict__ g_b1) {
    if (k >= H) return;  // warp-uniform
    float sdh = 0.f, sdhx = 0.f;
    for (int r = lane; r < B; r += 32) {
        const size_t i = (size_t)r * H + k;
        float dd = 0.f;
        if (FROM_HEADS) {
            for (int j = 0; j < L; ++j) {
                dd = fmaf(dmh[(size_t)r * L + j], wmu[(size_t)k * L + j], dd);
                dd = fmaf(dlh[(size_t)r * L + j], wlv[(size_t)k * L + j], dd);
            }
        } else {
            dd = sum_splits(dd_part, splits, (size_t)B * H, i);
        }
        const float dh = dd * dcoef[i];
        da1[i] = dh;
        sdh += dh;
        sdhx += dh * xhat[i];
    }
    sdh = warp_sum(sdh);
    sdhx = warp_sum(sdhx);
    const float g = gamma[k];
    const float mdx = g * sdh / (float)B;
    const float mdxx = g * sdhx / (float)B;
    const float inv = inv_std[k];
    float sb = 0.f;
    for (int r = lane; r < B; r += 32) {
        const size_t i = (size_t)r * H + k;
        const float v = inv * (da1[i] * g - mdx - xhat[i] * mdxx);
        da1[i] = v;
        sb += v;
    }
    sb = warp_sum(sb);
    if (lane == 0) {
        g_gamma[k] = sdhx;
        g_beta[k] = sdh;
        g_b1[k] = sb;
    }
}

// bn_backward_col's split-K form: dd from a product's partials.
template <bool PDL>
__global__ void __launch_bounds__(THREADS)
bn_backward_kernel(const float* __restrict__ dd_part, int splits,
                   const float* __restrict__ dcoef, const float* __restrict__ xhat,
                   const float* __restrict__ inv_std, const float* __restrict__ gamma, int B,
                   int H, float* __restrict__ da1, float* __restrict__ g_gamma,
                   float* __restrict__ g_beta, float* __restrict__ g_b1) {
    if constexpr (PDL) pdl_wait();
    bn_backward_col<false>(blockIdx.x * WARPS + (threadIdx.x >> 5), threadIdx.x & 31, nullptr,
                           nullptr, nullptr, nullptr, dd_part, splits, dcoef, xhat, inv_std,
                           gamma, B, H, 0, da1, g_gamma, g_beta, g_b1);
}

// An encoder's work after the posterior's backward that reads only dmh and
// dlh, in one launch: its last block's BatchNorm backward (a warp a column,
// blocks [0, bn_blocks)), its heads' gradients (a thread an output, the next
// head_blocks blocks) and the site embedding's (a thread a cell, the rest;
// none with S = 0). The parts are independent and each output is computed by
// one thread or warp in a fixed order, so the bits do not depend on the
// grouping.
struct HeadsBackward {
    const float *dmh, *dlh, *wmu, *wlv, *dcoef, *xhat, *inv_std, *gamma, *d, *e, *smu_w, *slv_w;
    const int64_t* site;
    float *da, *g_gamma, *g_beta, *g_b, *g_emb;
    HeadGrads hg;
    int B, H, L, S, E, bn_blocks, head_blocks, blocks;
};

// Block ``blk`` of one encoder's part of heads_backward_kernel.
__device__ __forceinline__ void heads_backward_block(const HeadsBackward& a, int blk) {
    if (blk < a.bn_blocks) {
        bn_backward_col<true>(blk * WARPS + (threadIdx.x >> 5), threadIdx.x & 31, a.dmh, a.dlh,
                              a.wmu, a.wlv, nullptr, 0, a.dcoef, a.xhat, a.inv_std, a.gamma, a.B,
                              a.H, a.L, a.da, a.g_gamma, a.g_beta, a.g_b);
        return;
    }
    blk -= a.bn_blocks;
    if (blk < a.head_blocks) {
        head_grad_at(blk * THREADS + threadIdx.x, a.d, a.e, a.dmh, a.dlh, a.B, a.H, a.E, a.L, a.hg);
        return;
    }
    blk -= a.head_blocks;
    emb_grad_at(blk * THREADS + threadIdx.x, a.site, a.dmh, a.dlh, a.smu_w, a.slv_w, a.B, a.S,
                a.E, a.L, a.g_emb);
}

// Up to two encoders' heads_backward in one launch: blocks [0, a.blocks)
// take ``a``, the rest ``b`` (blocks = 0: none).
template <bool PDL>
__global__ void __launch_bounds__(THREADS) heads_backward_kernel(const HeadsBackward a,
                                                                 const HeadsBackward b) {
    if constexpr (PDL) pdl_wait();
    if ((int)blockIdx.x < a.blocks) {
        heads_backward_block(a, blockIdx.x);
    } else {
        heads_backward_block(b, blockIdx.x - a.blocks);
    }
}

// The noise NOISE_PHILOX draws at (seed, step): dropout keep flags
// (B, hidden) of one stream and, when eps is given, eps (B, latent), for
// checking its statistics.
__global__ void noise_kernel(uint64_t seed, int step, int B, int H, int stream, int L,
                             float* __restrict__ keep, float* __restrict__ eps) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx < B * H) keep[idx] = philox_keep(seed, idx / H, idx % H, step, stream);
    if (eps && idx < B * L) eps[idx] = philox_normal(seed, idx / L, idx % L, step);
}

// torch-order AdamW over one flat buffer: decay first, then the
// bias-corrected Adam step; with ``ea``, lr, wd and step ``t``'s bias
// corrections come from it.
template <bool PDL>
__global__ void adamw_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                             const float* __restrict__ g, long long n, float lr, float wd,
                             float bc1, float bc2, const EpochArgs* ea, int t) {
    if constexpr (PDL) pdl_wait();
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (ea) {
        lr = ea->lr;
        wd = ea->wd;
        bc1 = epoch_bc(ea)[2 * t];
        bc2 = epoch_bc(ea)[2 * t + 1];
    }
    const float gi = g[i];
    const float nm = ADAM_B1 * m[i] + (1.0f - ADAM_B1) * gi;
    const float nv = ADAM_B2 * v[i] + (1.0f - ADAM_B2) * gi * gi;
    m[i] = nm;
    v[i] = nv;
    p[i] = p[i] * (1.0f - lr * wd) - lr * (nm / bc1) / (sqrtf(nv / bc2) + ADAM_EPS);
}

// ---------------------------------------------------------------------------
// Workspace plan, in floats.
struct Work {
    float *xhat, *dcoef, *d, *inv_std, *e, *mu, *lv, *epsv, *sigma, *z, *r1, *r2, *dlogits,
        *du2, *du1, *dmh, *dlh, *da1, *part, *scratch, *grads;
    size_t total;
};

size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

Work plan(float* base, const Dims& d, int B, bool with_grads) {
    Work w;
    size_t o = 0;
    auto take = [&](size_t n) {
        float* p = base ? base + o : nullptr;
        o += (n + 3) & ~(size_t)3;
        return p;
    };
    const size_t BH = (size_t)B * d.hid, BL = (size_t)B * d.latent;
    w.xhat = take(BH); w.dcoef = take(BH); w.d = take(BH); w.inv_std = take(d.hid);
    w.e = take((size_t)B * d.embed);
    w.mu = take(BL); w.lv = take(BL); w.epsv = take(BL); w.sigma = take(BL); w.z = take(BL);
    w.r1 = take((size_t)B * d.d1); w.r2 = take((size_t)B * d.d2);
    w.dlogits = take((size_t)B * d.out);
    w.du2 = take((size_t)B * d.d2); w.du1 = take((size_t)B * d.d1);
    w.dmh = take(BL); w.dlh = take(BL); w.da1 = take(BH);
    w.part = take(LOSS_BLOCKS);
    // the largest split-K product's partial sums
    const int shapes[6][3] = {{B, d.hid, d.in}, {B, d.d1, d.latent}, {B, d.d2, d.d1},
                              {B, d.out, d.d2}, {B, d.d2, d.out}, {B, d.d1, d.d2}};
    size_t scratch = 0;
    for (auto& s : shapes) {
        const Split sp = split_for(s[0], s[1], s[2], 1 << 20);
        scratch = max_sz(scratch, (size_t)sp.splits * s[0] * s[1]);
    }
    w.scratch = take(scratch);
    long long off[N_PARAMS];
    w.grads = with_grads ? take((size_t)param_offsets(d, off)) : nullptr;
    w.total = o;
    return w;
}

inline int blocks(size_t n, int t = THREADS) { return (int)((n + t - 1) / t); }

// Host side of gemm_group_kernel: products and column sums added one by one,
// then one launch. A product with a bias is not split (its tiles are written
// through bias + ReLU); the others split as gemm() splits them.
struct Group {
    const Queue& q;
    GemmGroup g{};
    int total = 0;

    explicit Group(const Queue& queue) : q(queue) {}

    void prod(Mat A, Mat B, float* C, int M, int N, int K, int max_splits, const float* bias,
              int* splits_out) {
        const Split s = split_for(M, N, K, bias ? 1 : max_splits);
        GroupProd& p = g.p[g.n_prods++];
        const int tiles_n = (N + TILE - 1) / TILE;
        p = GroupProd{A.p, B.p, bias, C, A.s0, A.s1, B.s0, B.s1, M, N, K, s.kchunk, tiles_n,
                      tiles_n * ((M + TILE - 1) / TILE), 0, q.early(B.p)};
        p.blocks = p.tiles * s.splits;
        total += p.blocks;
        if (splits_out) *splits_out = s.splits;
    }

    void colsum(const float* y, int M, int N, float* out) {
        g.cs[g.n_colsums++] = GroupColsum{y, out, M, N, blocks(N, GEMM_THREADS)};
        total += g.cs[g.n_colsums - 1].blocks;
    }

    int launch() const { return LAUNCH(q, gemm_group_kernel, dim3(total), GEMM_THREADS, g); }
};

struct ReluMasks {
    EpiGroup g{};
    int total = 0;

    void add(const float* part, int splits, int M, int N, const float* ref, float* out) {
        g.j[g.n++] = EpiJob{part, ref, out, splits, M, N, blocks((size_t)M * N)};
        total += g.j[g.n - 1].blocks;
    }

    int launch(const Queue& q) const {
        return LAUNCH(q, relu_mask_group_kernel, dim3(total), THREADS, g);
    }
};

#define CHECK(expr)                     \
    do {                                \
        const int _e = (int)(expr);     \
        if (_e != 0) return _e;         \
    } while (0)
#define LAUNCHED() CHECK(cudaGetLastError())

// Host side of bn_forward_kernel: one BatchNorm, or two independent ones.
int bn_forward(const Queue& q, const BnForward& a, const BnForward& b = BnForward{}) {
    const int total = blocks(a.H, WARPS) + blocks(b.H, WARPS);
    return LAUNCH(q, bn_forward_kernel, dim3(total), THREADS, a, b);
}

// Host side of heads_backward_kernel: the block ranges of each encoder's
// three parts (none for an encoder with H = 0).
void heads_backward_plan(HeadsBackward& a) {
    a.bn_blocks = blocks(a.H, WARPS);
    a.head_blocks = a.H ? blocks((size_t)2 * a.H * a.L + 2 * a.E * a.L + 2 * a.L) : 0;
    a.blocks = a.bn_blocks + a.head_blocks + blocks((size_t)a.S * a.E);
}

int heads_backward(HeadsBackward a, const Queue& q, HeadsBackward b = HeadsBackward{}) {
    heads_backward_plan(a);
    heads_backward_plan(b);
    return LAUNCH(q, heads_backward_kernel, dim3(a.blocks + b.blocks), THREADS, a, b);
}

// One step: forward, loss, every gradient, new BN running stats. ``ea`` (or
// null) gives the seed and beta in place of the arguments (EpochArgs),
// ``step_at`` (or null) the Philox step index in place of ``step`` (a step
// graph's StepArgs); ``q`` is how the phases launch.
//
// 17 launches: a backward phase's independent products (dW and the split
// dX) go out with the bias gradient's column sum as one gemm_group_kernel;
// the decoder's first layer (K = latent, not split) takes its bias and ReLU
// inside the product; the BatchNorm backward and the heads' and site
// embedding's gradients, which read only dmh and dlh, are one launch. Each
// product keeps its own tiles and split, so the arithmetic is that of one
// launch a product.
int step_phases(const float* x, const float* t, const int64_t* site, const float* p,
                const Dims& d, int B, const float* rm_in, const float* rv_in, float* rm_out,
                float* rv_out, const float* eps_in, const float* drop_in, int noise,
                uint64_t seed, int step, const int* step_at, float beta, const EpochArgs* ea,
                float* loss, float* g, const Work& w, const Queue& q) {
    long long off[N_PARAMS];
    param_offsets(d, off);
    const float* P[N_PARAMS];
    float* G[N_PARAMS];
    for (int i = 0; i < N_PARAMS; ++i) {
        P[i] = p + off[i];
        G[i] = g + off[i];
    }
    const int X = d.in, H = d.hid, L = d.latent, S = d.sites, E = d.embed;
    const int D1 = d.d1, D2 = d.d2, O = d.out;
    int sp = 1;
    const int BIG = 1 << 20;

    // ---- forward ----
    CHECK(gemm(Mat{x, X, 1}, Mat{P[W1], H, 1}, w.scratch, B, H, X, BIG, q, &sp));
    CHECK(bn_forward(q, BnForward{w.scratch, sp, B, H, P[B1], P[GAMMA], P[BNBETA], rm_in, rv_in,
                                  rm_out, rv_out, drop_in, noise, seed, ea, step, step_at,
                                  STREAM_DROPOUT, w.xhat, w.dcoef, w.d, w.inv_std}));
    const Heads heads = {P[WMU], P[BMU], P[WLV], P[BLV], P[EMB],
                         P[SMU_W], P[SMU_B], P[SLV_W], P[SLV_B]};
    CHECK(LAUNCH(q, posterior_kernel, dim3(blocks((size_t)B * L, WARPS)), THREADS, w.d, site,
        heads, B, H, L, S, E, eps_in, noise, seed, ea, step, step_at, w.e, w.mu, w.lv, w.epsv,
        w.sigma, w.z));
    {
        Group first(q);  // z . W + b through ReLU
        first.prod(Mat{w.z, L, 1}, Mat{P[D1W], D1, 1}, w.r1, B, D1, L, 1, P[D1B], nullptr);
        CHECK(first.launch());
    }
    CHECK(gemm(Mat{w.r1, D1, 1}, Mat{P[D2W], D2, 1}, w.scratch, B, D2, D1, BIG, q, &sp));
    CHECK(LAUNCH(q, epilogue_kernel, dim3(blocks((size_t)B * D2)), THREADS, w.scratch, sp, B, D2,
        P[D2B], nullptr, w.r2, EPI_BIAS_RELU));
    CHECK(gemm(Mat{w.r2, D2, 1}, Mat{P[D3W], O, 1}, w.scratch, B, O, D2, BIG, q, &sp));
    CHECK(LAUNCH(q, logits_kernel, dim3(LOSS_BLOCKS), THREADS, w.scratch, sp, B, O, P[D3B], t,
        w.dlogits, w.part));
    CHECK(LAUNCH(q, loss_finish_kernel, dim3(1), THREADS, w.part, LOSS_BLOCKS, w.mu, w.lv, B * L,
        beta, ea, loss));

    // ---- backward: decoder (dW = act^T . dy, db = column sums of dy, dx = dy . W^T) ----
    {
        Group out(q);
        out.prod(Mat{w.r2, 1, D2}, Mat{w.dlogits, O, 1}, G[D3W], D2, O, B, 1, nullptr, nullptr);
        out.prod(Mat{w.dlogits, O, 1}, Mat{P[D3W], 1, O}, w.scratch, B, D2, O, BIG, nullptr, &sp);
        out.colsum(w.dlogits, B, O, G[D3B]);
        CHECK(out.launch());
    }
    CHECK(LAUNCH(q, epilogue_kernel, dim3(blocks((size_t)B * D2)), THREADS, w.scratch, sp, B, D2,
        nullptr, w.r2, w.du2, EPI_RELU_MASK));
    {
        Group mid(q);
        mid.prod(Mat{w.r1, 1, D1}, Mat{w.du2, D2, 1}, G[D2W], D1, D2, B, 1, nullptr, nullptr);
        mid.prod(Mat{w.du2, D2, 1}, Mat{P[D2W], 1, D2}, w.scratch, B, D1, D2, BIG, nullptr, &sp);
        mid.colsum(w.du2, B, D2, G[D2B]);
        CHECK(mid.launch());
    }
    CHECK(LAUNCH(q, epilogue_kernel, dim3(blocks((size_t)B * D1)), THREADS, w.scratch, sp, B, D1,
        nullptr, w.r1, w.du1, EPI_RELU_MASK));
    {
        Group first(q);
        first.prod(Mat{w.z, 1, L}, Mat{w.du1, D1, 1}, G[D1W], L, D1, B, 1, nullptr, nullptr);
        first.colsum(w.du1, B, D1, G[D1B]);
        CHECK(first.launch());
    }

    // ---- backward: posterior, then heads, site embedding and encoder BN in one launch ----
    CHECK(LAUNCH(q, posterior_backward_kernel, dim3(blocks((size_t)B * L, WARPS)), THREADS, w.du1,
        P[D1W], B, D1, L, w.mu, w.lv, w.epsv, w.sigma, beta, ea, w.dmh, w.dlh));
    HeadsBackward hb{};
    hb.dmh = w.dmh; hb.dlh = w.dlh; hb.wmu = P[WMU]; hb.wlv = P[WLV];
    hb.dcoef = w.dcoef; hb.xhat = w.xhat; hb.inv_std = w.inv_std; hb.gamma = P[GAMMA];
    hb.d = w.d; hb.e = w.e; hb.smu_w = P[SMU_W]; hb.slv_w = P[SLV_W]; hb.site = site;
    hb.da = w.da1; hb.g_gamma = G[GAMMA]; hb.g_beta = G[BNBETA]; hb.g_b = G[B1];
    hb.g_emb = G[EMB];
    hb.hg = HeadGrads{G[WMU], G[BMU], G[WLV], G[BLV], G[SMU_W], G[SMU_B], G[SLV_W], G[SLV_B]};
    hb.B = B; hb.H = H; hb.L = L; hb.S = S; hb.E = E;
    CHECK(heads_backward(hb, q));
    CHECK(gemm(Mat{x, 1, X}, Mat{w.da1, H, 1}, G[W1], X, H, B, 1, q, nullptr));
    return 0;
}

// The epoch's launches on ``q``: for each step i, step_phases on rows
// [i * B, (i + 1) * B) with Philox step index i, then AdamW with step i's
// bias corrections; seed, beta, lr and wd come from ``ea``. bn: rm then rv.
int epoch_phases(const float* x_ep, const float* t_ep, const int64_t* site_ep, float* params,
                 float* m, float* v, const Dims& d, int batch, int n_batches, float* bn,
                 const float* eps_ep, const float* drop_ep, int noise, const EpochArgs* ea,
                 float* losses, const Work& w, const Queue& q) {
    long long off[N_PARAMS];
    const long long n_params = param_offsets(d, off);
    const bool inj = noise == NOISE_INJECTED;
    float* rm = bn;
    float* rv = bn + d.hid;
    for (int i = 0; i < n_batches; ++i) {
        const size_t r0 = (size_t)i * batch;
        CHECK(step_phases(x_ep + r0 * d.in, t_ep + r0 * d.out, site_ep + r0, params, d, batch, rm,
                          rv, rm, rv, inj ? eps_ep + r0 * d.latent : nullptr,
                          inj ? drop_ep + r0 * d.hid : nullptr, noise, 0, i, nullptr, 0.f, ea,
                          losses + i, w.grads, w, q));
        CHECK(LAUNCH(q, adamw_kernel, dim3(blocks((size_t)n_params)), THREADS, params, m, v,
            w.grads, n_params, 0.f, 0.f, 1.f, 1.f, ea, i));
    }
    return 0;
}

bool valid(const Dims& d, int B) {
    return B >= 1 && d.in > 0 && d.hid > 0 && d.latent > 0 && d.sites > 0 && d.embed > 0 &&
           d.d1 > 0 && d.d2 > 0 && d.out > 0;
}

Dims dims_from(const int* dims) {
    return Dims{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7]};
}

// ---------------------------------------------------------------------------
// DNA->RNA: EncoderB (two Linear -> BatchNorm -> ReLU -> dropout blocks),
// the site posterior, DecoderA (latent -> d1 -> ReLU -> out, linear), MSE sum
// + beta * KLD. The same phase kernels as RNA->DNA; what differs is the
// chain: two BN blocks (the second's dropout on Philox stream
// STREAM_DROPOUT2), block 1's upstream gradient dd1 = da2 . W2^T as a split-K
// product read by the buffered BN backward, and the MSE head.
namespace d2r {

// PARAM_ORDER_D2R of ops/kernels/fused_train.py, JAX layout.
enum Param {
    W1, B1, G1, BT1, W2, B2, G2, BT2, WMU, BMU, WLV, BLV, EMB, SMU_W, SMU_B, SLV_W, SLV_B,
    D1W, D1B, D2W, D2B, N_PARAMS
};

struct Dims {
    int in, h1, h2, latent, sites, embed, d1, out;
};

Dims from(const int* dims) {
    return Dims{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7]};
}

bool valid(const Dims& d, int B) {
    return B >= 1 && d.in > 0 && d.h1 > 0 && d.h2 > 0 && d.latent > 0 && d.sites > 0 &&
           d.embed > 0 && d.d1 > 0 && d.out > 0;
}

long long param_offsets(const Dims& d, long long* off) {
    long long s[N_PARAMS];
    s[W1] = (long long)d.in * d.h1; s[B1] = d.h1; s[G1] = d.h1; s[BT1] = d.h1;
    s[W2] = (long long)d.h1 * d.h2; s[B2] = d.h2; s[G2] = d.h2; s[BT2] = d.h2;
    s[WMU] = (long long)d.h2 * d.latent; s[BMU] = d.latent;
    s[WLV] = (long long)d.h2 * d.latent; s[BLV] = d.latent;
    s[EMB] = (long long)d.sites * d.embed;
    s[SMU_W] = (long long)d.embed * d.latent; s[SMU_B] = d.latent;
    s[SLV_W] = (long long)d.embed * d.latent; s[SLV_B] = d.latent;
    s[D1W] = (long long)d.latent * d.d1; s[D1B] = d.d1;
    s[D2W] = (long long)d.d1 * d.out; s[D2B] = d.out;
    long long total = 0;
    for (int i = 0; i < N_PARAMS; ++i) {
        off[i] = total;
        total += s[i];
    }
    return total;
}

struct Work {
    float *xhat1, *dcoef1, *d1, *inv1, *xhat2, *dcoef2, *d2, *inv2, *e, *mu, *lv, *epsv, *sigma,
        *z, *rd1, *drecon, *du1, *dmh, *dlh, *da2, *da1, *part, *scratch, *grads;
    size_t total;
};

Work plan(float* base, const Dims& d, int B, bool with_grads) {
    Work w;
    size_t o = 0;
    auto take = [&](size_t n) {
        float* p = base ? base + o : nullptr;
        o += (n + 3) & ~(size_t)3;
        return p;
    };
    const size_t BH1 = (size_t)B * d.h1, BH2 = (size_t)B * d.h2, BL = (size_t)B * d.latent;
    w.xhat1 = take(BH1); w.dcoef1 = take(BH1); w.d1 = take(BH1); w.inv1 = take(d.h1);
    w.xhat2 = take(BH2); w.dcoef2 = take(BH2); w.d2 = take(BH2); w.inv2 = take(d.h2);
    w.e = take((size_t)B * d.embed);
    w.mu = take(BL); w.lv = take(BL); w.epsv = take(BL); w.sigma = take(BL); w.z = take(BL);
    w.rd1 = take((size_t)B * d.d1); w.drecon = take((size_t)B * d.out);
    w.du1 = take((size_t)B * d.d1);
    w.dmh = take(BL); w.dlh = take(BL); w.da2 = take(BH2); w.da1 = take(BH1);
    w.part = take(LOSS_BLOCKS);
    // the largest split-K product's partial sums
    const int shapes[6][3] = {{B, d.h1, d.in}, {B, d.h2, d.h1}, {B, d.d1, d.latent},
                              {B, d.out, d.d1}, {B, d.d1, d.out}, {B, d.h1, d.h2}};
    size_t scratch = 0;
    for (auto& s : shapes) {
        const Split sp = split_for(s[0], s[1], s[2], 1 << 20);
        scratch = max_sz(scratch, (size_t)sp.splits * s[0] * s[1]);
    }
    w.scratch = take(scratch);
    long long off[N_PARAMS];
    w.grads = with_grads ? take((size_t)param_offsets(d, off)) : nullptr;
    w.total = o;
    return w;
}

// One step: forward, loss, every gradient, the new running stats of both
// BatchNorms. bn_in/bn_out: rm1 (h1), rv1 (h1), rm2 (h2), rv2 (h2). ``ea``
// (or null) gives the seed and beta in place of the arguments, ``step_at``
// (or null) the step index, as RNA->DNA's.
//
// 17 launches, grouped as RNA->DNA's are: the decoder's backward products
// with their column sums, dW2 with the split dd1 = da2 . W2^T, the first
// decoder layer with its bias and ReLU, and block 2's BatchNorm backward
// with the heads' and the embedding's gradients.
int step_phases(const float* x, const float* t, const int64_t* site, const float* p,
                const Dims& d, int B, const float* bn_in, float* bn_out, const float* eps_in,
                const float* drop1_in, const float* drop2_in, int noise, uint64_t seed, int step,
                const int* step_at, float beta, const EpochArgs* ea, float* loss, float* g,
                const Work& w, const Queue& q) {
    long long off[N_PARAMS];
    param_offsets(d, off);
    const float* P[N_PARAMS];
    float* G[N_PARAMS];
    for (int i = 0; i < N_PARAMS; ++i) {
        P[i] = p + off[i];
        G[i] = g + off[i];
    }
    const int X = d.in, H1 = d.h1, H2 = d.h2, L = d.latent, S = d.sites, E = d.embed;
    const int D1 = d.d1, O = d.out;
    int sp = 1;
    const int BIG = 1 << 20;

    // ---- forward: encoder blocks 1 and 2, posterior, decoder, loss ----
    CHECK(gemm(Mat{x, X, 1}, Mat{P[W1], H1, 1}, w.scratch, B, H1, X, BIG, q, &sp));
    CHECK(bn_forward(q, BnForward{w.scratch, sp, B, H1, P[B1], P[G1], P[BT1], bn_in, bn_in + H1,
                                  bn_out, bn_out + H1, drop1_in, noise, seed, ea, step, step_at,
                                  STREAM_DROPOUT, w.xhat1, w.dcoef1, w.d1, w.inv1}));
    CHECK(gemm(Mat{w.d1, H1, 1}, Mat{P[W2], H2, 1}, w.scratch, B, H2, H1, BIG, q, &sp));
    const float* bn2_in = bn_in + 2 * H1;
    float* bn2_out = bn_out + 2 * H1;
    CHECK(bn_forward(q, BnForward{w.scratch, sp, B, H2, P[B2], P[G2], P[BT2], bn2_in, bn2_in + H2,
                                  bn2_out, bn2_out + H2, drop2_in, noise, seed, ea, step, step_at,
                                  STREAM_DROPOUT2, w.xhat2, w.dcoef2, w.d2, w.inv2}));
    const Heads heads = {P[WMU], P[BMU], P[WLV], P[BLV], P[EMB],
                         P[SMU_W], P[SMU_B], P[SLV_W], P[SLV_B]};
    CHECK(LAUNCH(q, posterior_kernel, dim3(blocks((size_t)B * L, WARPS)), THREADS, w.d2, site,
        heads, B, H2, L, S, E, eps_in, noise, seed, ea, step, step_at, w.e, w.mu, w.lv, w.epsv,
        w.sigma, w.z));
    {
        Group first(q);  // z . W + b through ReLU
        first.prod(Mat{w.z, L, 1}, Mat{P[D1W], D1, 1}, w.rd1, B, D1, L, 1, P[D1B], nullptr);
        CHECK(first.launch());
    }
    CHECK(gemm(Mat{w.rd1, D1, 1}, Mat{P[D2W], O, 1}, w.scratch, B, O, D1, BIG, q, &sp));
    CHECK(LAUNCH(q, mse_kernel, dim3(LOSS_BLOCKS), THREADS, w.scratch, sp, B, O, P[D2B], t,
        w.drecon, w.part));
    CHECK(LAUNCH(q, loss_finish_kernel, dim3(1), THREADS, w.part, LOSS_BLOCKS, w.mu, w.lv, B * L,
        beta, ea, loss));

    // ---- backward: decoder (dW = act^T . dy, db = column sums of dy, dx = dy . W^T) ----
    {
        Group out(q);
        out.prod(Mat{w.rd1, 1, D1}, Mat{w.drecon, O, 1}, G[D2W], D1, O, B, 1, nullptr, nullptr);
        out.prod(Mat{w.drecon, O, 1}, Mat{P[D2W], 1, O}, w.scratch, B, D1, O, BIG, nullptr, &sp);
        out.colsum(w.drecon, B, O, G[D2B]);
        CHECK(out.launch());
    }
    CHECK(LAUNCH(q, epilogue_kernel, dim3(blocks((size_t)B * D1)), THREADS, w.scratch, sp, B, D1,
        nullptr, w.rd1, w.du1, EPI_RELU_MASK));
    {
        Group first(q);
        first.prod(Mat{w.z, 1, L}, Mat{w.du1, D1, 1}, G[D1W], L, D1, B, 1, nullptr, nullptr);
        first.colsum(w.du1, B, D1, G[D1B]);
        CHECK(first.launch());
    }

    // ---- backward: posterior, then heads, site embedding and block 2's BN in one launch ----
    CHECK(LAUNCH(q, posterior_backward_kernel, dim3(blocks((size_t)B * L, WARPS)), THREADS, w.du1,
        P[D1W], B, D1, L, w.mu, w.lv, w.epsv, w.sigma, beta, ea, w.dmh, w.dlh));
    HeadsBackward hb{};
    hb.dmh = w.dmh; hb.dlh = w.dlh; hb.wmu = P[WMU]; hb.wlv = P[WLV];
    hb.dcoef = w.dcoef2; hb.xhat = w.xhat2; hb.inv_std = w.inv2; hb.gamma = P[G2];
    hb.d = w.d2; hb.e = w.e; hb.smu_w = P[SMU_W]; hb.slv_w = P[SLV_W]; hb.site = site;
    hb.da = w.da2; hb.g_gamma = G[G2]; hb.g_beta = G[BT2]; hb.g_b = G[B2];
    hb.g_emb = G[EMB];
    hb.hg = HeadGrads{G[WMU], G[BMU], G[WLV], G[BLV], G[SMU_W], G[SMU_B], G[SLV_W], G[SLV_B]};
    hb.B = B; hb.H = H2; hb.L = L; hb.S = S; hb.E = E;
    CHECK(heads_backward(hb, q));

    // ---- backward: block 1 through dd1 = da2 . W2^T ----
    {
        Group enc(q);
        enc.prod(Mat{w.d1, 1, H1}, Mat{w.da2, H2, 1}, G[W2], H1, H2, B, 1, nullptr, nullptr);
        enc.prod(Mat{w.da2, H2, 1}, Mat{P[W2], 1, H2}, w.scratch, B, H1, H2, BIG, nullptr, &sp);
        CHECK(enc.launch());
    }
    CHECK(LAUNCH(q, bn_backward_kernel, dim3(blocks(H1, WARPS)), THREADS, w.scratch, sp, w.dcoef1,
        w.xhat1, w.inv1, P[G1], B, H1, w.da1, G[G1], G[BT1], G[B1]));
    CHECK(gemm(Mat{x, 1, X}, Mat{w.da1, H1, 1}, G[W1], X, H1, B, 1, q, nullptr));
    return 0;
}

// The epoch's launches on ``q``, as RNA->DNA's (bn: rm1, rv1, rm2, rv2).
int epoch_phases(const float* x_ep, const float* t_ep, const int64_t* site_ep, float* params,
                 float* m, float* v, const Dims& d, int batch, int n_batches, float* bn,
                 const float* eps_ep, const float* drop1_ep, const float* drop2_ep, int noise,
                 const EpochArgs* ea, float* losses, const Work& w, const Queue& q) {
    long long off[N_PARAMS];
    const long long n_params = param_offsets(d, off);
    const bool inj = noise == NOISE_INJECTED;
    for (int i = 0; i < n_batches; ++i) {
        const size_t r0 = (size_t)i * batch;
        CHECK(step_phases(x_ep + r0 * d.in, t_ep + r0 * d.out, site_ep + r0, params, d, batch,
                          bn, bn, inj ? eps_ep + r0 * d.latent : nullptr,
                          inj ? drop1_ep + r0 * d.h1 : nullptr,
                          inj ? drop2_ep + r0 * d.h2 : nullptr, noise, 0, i, nullptr, 0.f, ea,
                          losses + i, w.grads, w, q));
        CHECK(LAUNCH(q, adamw_kernel, dim3(blocks((size_t)n_params)), THREADS, params, m, v,
            w.grads, n_params, 0.f, 0.f, 1.f, 1.f, ea, i));
    }
    return 0;
}

}  // namespace d2r

// ---------------------------------------------------------------------------
// Tri-modal MultiModalVAE: EncoderA (RNA: one Linear -> BatchNorm -> ReLU ->
// dropout block), EncoderB (DNA: two such blocks), EncoderC (site
// embedding), the mean of the three posteriors, DecoderA (latent -> 128 ->
// RNA, linear), DecoderB (latent -> 256 -> 512 -> DNA logits), DecoderC
// (latent -> 64 -> site logits), and the loss MSE sum + BCE sum + gamma *
// class-weighted CE sum + beta * KLD. The same phase kernels as the
// directional steps; new are the three-source posterior and its backward,
// the cross-entropy head and the four-term loss finish.
//
// The epoch (multimodal_train_epoch, replacing the TPU kernel of
// vae_los_angeles_tpu/ops/pallas/fused_epoch_multimodal.py, _mm_epoch_call):
// a 200-step epoch at B = 32 is ~1 ms of fp32 FMA at 67 TFLOP/s, but as a
// host loop it was ~11,200 dependent launches, each enqueued in ~5 us while
// the card ran it in ~3.75 us, so the host set the pace and the card idled
// ~29% of the epoch. The design: (1) the host leaves the step. The epoch's
// launches are captured once into a CUDA graph (multimodal_epoch_graph_create),
// cached by the wrapper with the buffers they address, and replayed with one
// cudaGraphLaunch an epoch; what changes between epochs (seed, beta, gamma,
// lr, wd and each step's bias corrections) is read from a small device
// buffer (EpochArgs), while the Philox step index and the row offsets,
// fixed within an epoch, stay baked. (2) Fewer launches a step, 22 with the
// AdamW (from 56): independent products of a phase grouped in one launch
// with the bias gradients' column sums, the decoders' first layers with their
// bias and ReLU inside the product, the three ReLU-masked upstream gradients
// in one launch, two encoders' BN forwards in one, the three decoders' heads
// in one, both encoders' last BN backward with their heads' gradients in one.
// No atomics; each product keeps its tiles and split, so one
// input gives one set of bits.
namespace mm {

// PARAM_ORDER_MM of ops/kernels/fused_train.py, JAX layout.
enum Param {
    A_W1, A_B1, A_G, A_BT, A_WMU, A_BMU, A_WLV, A_BLV,
    B_W1, B_B1, B_G1, B_BT1, B_W2, B_B2, B_G2, B_BT2, B_WMU, B_BMU, B_WLV, B_BLV,
    EMB, C_WMU, C_BMU, C_WLV, C_BLV,
    DA_W1, DA_B1, DA_W2, DA_B2,
    DB_W1, DB_B1, DB_W2, DB_B2, DB_W3, DB_B3,
    DC_W1, DC_B1, DC_W2, DC_B2, N_PARAMS
};

// in_a (RNA), in_b (DNA), EncoderA's hidden, EncoderB's two, latent, sites,
// embedding, DecoderA's hidden, DecoderB's two, DecoderC's hidden.
struct Dims {
    int a, b, ha, hb1, hb2, latent, sites, embed, da, db1, db2, dc;
};

constexpr int N_DIMS = 12;

Dims from(const int* d) {
    return Dims{d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7], d[8], d[9], d[10], d[11]};
}

bool valid(const Dims& d, int B) {
    return B >= 1 && d.a > 0 && d.b > 0 && d.ha > 0 && d.hb1 > 0 && d.hb2 > 0 && d.latent > 0 &&
           d.sites > 0 && d.embed > 0 && d.da > 0 && d.db1 > 0 && d.db2 > 0 && d.dc > 0;
}

long long param_offsets(const Dims& d, long long* off) {
    const long long L = d.latent;
    long long s[N_PARAMS];
    s[A_W1] = (long long)d.a * d.ha; s[A_B1] = d.ha; s[A_G] = d.ha; s[A_BT] = d.ha;
    s[A_WMU] = d.ha * L; s[A_BMU] = L; s[A_WLV] = d.ha * L; s[A_BLV] = L;
    s[B_W1] = (long long)d.b * d.hb1; s[B_B1] = d.hb1; s[B_G1] = d.hb1; s[B_BT1] = d.hb1;
    s[B_W2] = (long long)d.hb1 * d.hb2; s[B_B2] = d.hb2; s[B_G2] = d.hb2; s[B_BT2] = d.hb2;
    s[B_WMU] = d.hb2 * L; s[B_BMU] = L; s[B_WLV] = d.hb2 * L; s[B_BLV] = L;
    s[EMB] = (long long)d.sites * d.embed;
    s[C_WMU] = d.embed * L; s[C_BMU] = L; s[C_WLV] = d.embed * L; s[C_BLV] = L;
    s[DA_W1] = L * d.da; s[DA_B1] = d.da; s[DA_W2] = (long long)d.da * d.a; s[DA_B2] = d.a;
    s[DB_W1] = L * d.db1; s[DB_B1] = d.db1; s[DB_W2] = (long long)d.db1 * d.db2;
    s[DB_B2] = d.db2; s[DB_W3] = (long long)d.db2 * d.b; s[DB_B3] = d.b;
    s[DC_W1] = L * d.dc; s[DC_B1] = d.dc; s[DC_W2] = (long long)d.dc * d.sites;
    s[DC_B2] = d.sites;
    long long total = 0;
    for (int i = 0; i < N_PARAMS; ++i) {
        off[i] = total;
        total += s[i];
    }
    return total;
}

// Running statistics, one buffer: a_rm, a_rv (ha), b_rm1, b_rv1 (hb1),
// b_rm2, b_rv2 (hb2).
long long bn_floats(const Dims& d) { return 2LL * (d.ha + d.hb1 + d.hb2); }

struct Heads3 {
    const float *a_wmu, *a_bmu, *a_wlv, *a_blv, *b_wmu, *b_bmu, *b_wlv, *b_blv, *emb, *c_wmu,
        *c_bmu, *c_wlv, *c_blv;
};

// The three posteriors, their mean and z: one warp per (row, latent index),
// its lanes over each head's input index; the grid's threads also store the
// gathered embedding rows. mu = (mu_a + mu_b + mu_c) * (1/3) in that order,
// as the TPU kernel adds them.
template <bool PDL>
__global__ void __launch_bounds__(THREADS)
posterior3_kernel(const float* __restrict__ da, int HA, const float* __restrict__ db, int HB,
                  const int64_t* __restrict__ site, Heads3 w, int B, int L, int S, int E,
                  const float* __restrict__ eps_in, int noise, uint64_t seed,
                  const EpochArgs* ea, int step, const int* step_at, float* __restrict__ e, float* __restrict__ mu, float* __restrict__ lv,
                  float* __restrict__ epsv, float* __restrict__ sigma, float* __restrict__ z) {
    if constexpr (PDL) pdl_wait();
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    for (int idx = tid; idx < B * E; idx += gridDim.x * blockDim.x) {
        const int r = idx / E, c = idx - r * E;
        const int64_t s = site[r];
        e[idx] = (s >= 0 && s < S) ? w.emb[s * E + c] : 0.f;
    }
    const int idx = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (idx >= B * L) return;  // warp-uniform
    const int r = idx / L, j = idx - r * L;
    float ma = 0.f, la = 0.f, mb = 0.f, lb = 0.f, mc = 0.f, lc = 0.f;
    for (int k = lane; k < HA; k += 32) {
        const float v = da[(size_t)r * HA + k];
        ma = fmaf(v, w.a_wmu[(size_t)k * L + j], ma);
        la = fmaf(v, w.a_wlv[(size_t)k * L + j], la);
    }
    for (int k = lane; k < HB; k += 32) {
        const float v = db[(size_t)r * HB + k];
        mb = fmaf(v, w.b_wmu[(size_t)k * L + j], mb);
        lb = fmaf(v, w.b_wlv[(size_t)k * L + j], lb);
    }
    const int64_t s = site[r];
    const bool ok = s >= 0 && s < S;
    for (int c = lane; c < E; c += 32) {
        const float v = ok ? w.emb[s * E + c] : 0.f;
        mc = fmaf(v, w.c_wmu[(size_t)c * L + j], mc);
        lc = fmaf(v, w.c_wlv[(size_t)c * L + j], lc);
    }
    ma = warp_sum(ma) + w.a_bmu[j];
    la = warp_sum(la) + w.a_blv[j];
    mb = warp_sum(mb) + w.b_bmu[j];
    lb = warp_sum(lb) + w.b_blv[j];
    mc = warp_sum(mc) + w.c_bmu[j];
    lc = warp_sum(lc) + w.c_blv[j];
    if (lane != 0) return;
    const float third = 1.0f / 3.0f;
    const float m = (ma + mb + mc) * third;
    const float v = (la + lb + lc) * third;
    const float ep = noise == NOISE_PHILOX
                         ? philox_normal(ea ? ea->seed : seed, r, j, step_index(step_at, step))
                         : eps_in[idx];
    const float sg = expf(0.5f * v);
    mu[idx] = m;
    lv[idx] = v;
    epsv[idx] = ep;
    sigma[idx] = sg;
    z[idx] = m + ep * sg;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
    return v;
}

// The site head: logits = sum of partials + bias, a stable log-softmax,
// ce_rows[r] = w[y] * -log_softmax[y] and dlogits = (gamma * w[y]) *
// (softmax - one_hot(y)). One warp per row, its lanes over the classes;
// cw == nullptr means every weight is 1. The wrapper refuses a label outside
// [0, S).
__device__ __forceinline__ void ce_row(const float* __restrict__ acc_part, int splits, int B,
                                       int S, const float* __restrict__ bias,
                                       const int64_t* __restrict__ site,
                                       const float* __restrict__ cw, float gamma,
                                       const EpochArgs* ea, float* __restrict__ dlogits,
                                       float* __restrict__ ce_rows, int r, int lane) {
    if (r >= B) return;  // warp-uniform
    const size_t mn = (size_t)B * S;
    float mx = -INFINITY;
    for (int c = lane; c < S; c += 32)
        mx = fmaxf(mx, sum_splits(acc_part, splits, mn, (size_t)r * S + c) + bias[c]);
    mx = warp_max(mx);
    float se = 0.f;
    for (int c = lane; c < S; c += 32)
        se += expf((sum_splits(acc_part, splits, mn, (size_t)r * S + c) + bias[c]) - mx);
    const float lse = logf(warp_sum(se));
    const int64_t y = site[r];
    const float wy = cw ? cw[y] : 1.f;
    const float gw = (ea ? ea->gamma : gamma) * wy;
    float nll = 0.f;
    for (int c = lane; c < S; c += 32) {
        const float lp = ((sum_splits(acc_part, splits, mn, (size_t)r * S + c) + bias[c]) - mx) - lse;
        const float oh = c == y ? 1.f : 0.f;
        if (c == y) nll = -lp;
        dlogits[(size_t)r * S + c] = gw * (expf(lp) - oh);
    }
    nll = warp_sum(nll);  // one lane holds it, the others add zeros
    if (lane == 0) ce_rows[r] = wy * nll;
}

// The three decoders' heads after their second products, independent of one
// another, in one launch: blocks [0, LOSS_BLOCKS) DecoderA's MSE head
// (mse_kernel's), then a thread an element of DecoderB's middle layer
// relu(sum of partials + bias) (epilogue_kernel's EPI_BIAS_RELU), then a
// warp a row of the site head (ce_row).
struct MmHeads {
    const float *mse_part, *mse_bias, *target_a;
    float *drecon, *part_mse;
    const float *rb2_part, *rb2_bias;
    float* rb2;
    const float *ce_part, *ce_bias, *cw;
    const int64_t* site;
    float gamma;
    const EpochArgs* ea;
    float *dlogits_c, *ce_rows;
    int mse_splits, rb2_splits, ce_splits, B, A, DB2, S;
};

template <bool PDL>
__global__ void __launch_bounds__(THREADS) mm_heads_kernel(const MmHeads h) {
    if constexpr (PDL) pdl_wait();
    int blk = blockIdx.x;
    if (blk < LOSS_BLOCKS) {
        mse_block(h.mse_part, h.mse_splits, h.B, h.A, h.mse_bias, h.target_a, h.drecon,
                  h.part_mse, blk, LOSS_BLOCKS);
        return;
    }
    blk -= LOSS_BLOCKS;
    const size_t mn = (size_t)h.B * h.DB2;
    const int rb2_blocks = (int)((mn + THREADS - 1) / THREADS);
    if (blk < rb2_blocks) {
        const size_t idx = (size_t)blk * THREADS + threadIdx.x;
        if (idx < mn) h.rb2[idx] = fmaxf(sum_splits(h.rb2_part, h.rb2_splits, mn, idx)
                                         + h.rb2_bias[idx % h.DB2], 0.f);
        return;
    }
    blk -= rb2_blocks;
    ce_row(h.ce_part, h.ce_splits, h.B, h.S, h.ce_bias, h.site, h.cw, h.gamma, h.ea,
           h.dlogits_c, h.ce_rows, blk * WARPS + (threadIdx.x >> 5), threadIdx.x & 31);
}

// loss = mse + bce + gamma * ce + beta * KLD from the block sums of the MSE
// and BCE heads, the CE rows and the posterior, in fixed trees; one block.
template <bool PDL>
__global__ void __launch_bounds__(THREADS)
loss_finish4_kernel(const float* __restrict__ part_mse, const float* __restrict__ part_bce,
                   int n_part, const float* __restrict__ ce_rows, int B,
                   const float* __restrict__ mu, const float* __restrict__ lv, int n_lat,
                   float beta, float gamma, const EpochArgs* ea, float* loss) {
    if constexpr (PDL) pdl_wait();
    __shared__ float r0[THREADS], r1[THREADS], r2[THREADS], r3[THREADS];
    float a = 0.f, b = 0.f, c = 0.f, k = 0.f;
    for (int i = threadIdx.x; i < n_part; i += THREADS) {
        a += part_mse[i];
        b += part_bce[i];
    }
    for (int i = threadIdx.x; i < B; i += THREADS) c += ce_rows[i];
    for (int i = threadIdx.x; i < n_lat; i += THREADS) {
        const float m = mu[i], v = lv[i];
        k += 1.0f + v - m * m - expf(v);
    }
    r0[threadIdx.x] = a;
    r1[threadIdx.x] = b;
    r2[threadIdx.x] = c;
    r3[threadIdx.x] = k;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) {
            r0[threadIdx.x] += r0[threadIdx.x + s];
            r1[threadIdx.x] += r1[threadIdx.x + s];
            r2[threadIdx.x] += r2[threadIdx.x + s];
            r3[threadIdx.x] += r3[threadIdx.x + s];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        if (ea) {
            beta = ea->beta;
            gamma = ea->gamma;
        }
        *loss = r0[0] + r1[0] + gamma * r2[0] + beta * (-0.5f * r3[0]);
    }
}

// dz = dua . da_w1^T + dub1 . db_w1^T + duc . dc_w1^T (added in that order),
// then the posterior's backward: dmu/3 and dlogvar/3 (each of the three
// fused posteriors takes a third). One warp per (row, j).
template <bool PDL>
__global__ void __launch_bounds__(THREADS)
posterior3_backward_kernel(const float* __restrict__ dua, const float* __restrict__ da_w1,
                           int DA, const float* __restrict__ dub1,
                           const float* __restrict__ db_w1, int DB1,
                           const float* __restrict__ duc, const float* __restrict__ dc_w1,
                           int DC, int B, int L, const float* __restrict__ mu,
                           const float* __restrict__ lv, const float* __restrict__ epsv,
                           const float* __restrict__ sigma, float beta, const EpochArgs* ea,
                           float* __restrict__ dmh, float* __restrict__ dlh) {
    if constexpr (PDL) pdl_wait();
    const int idx = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (idx >= B * L) return;  // warp-uniform
    const int r = idx / L, j = idx - r * L;
    if (ea) beta = ea->beta;
    float za = 0.f, zb = 0.f, zc = 0.f;
    for (int k = lane; k < DA; k += 32) za = fmaf(dua[(size_t)r * DA + k], da_w1[(size_t)j * DA + k], za);
    for (int k = lane; k < DB1; k += 32)
        zb = fmaf(dub1[(size_t)r * DB1 + k], db_w1[(size_t)j * DB1 + k], zb);
    for (int k = lane; k < DC; k += 32) zc = fmaf(duc[(size_t)r * DC + k], dc_w1[(size_t)j * DC + k], zc);
    const float dz = (warp_sum(za) + warp_sum(zb)) + warp_sum(zc);
    if (lane != 0) return;
    const float third = 1.0f / 3.0f;
    const float dmu = dz + beta * mu[idx];
    const float dlv = dz * epsv[idx] * 0.5f * sigma[idx] + (-0.5f * beta) * (1.0f - expf(lv[idx]));
    dmh[idx] = third * dmu;
    dlh[idx] = third * dlv;
}

struct Work {
    float *xa, *dca, *ad, *inva, *xb1, *dcb1, *bd1, *invb1, *xb2, *dcb2, *bd2, *invb2, *e, *mu,
        *lv, *epsv, *sigma, *z, *ra, *rb1, *rb2, *rc, *drecon, *dlogits_b, *dlogits_c, *ce_rows,
        *dua, *dub2, *dub1, *duc, *dmh, *dlh, *daa, *dba2, *dba1, *part_mse, *part_bce, *scratch,
        *scratch_b, *scratch_c, *grads;
    size_t total;
};

Work plan(float* base, const Dims& d, int B, bool with_grads) {
    Work w;
    size_t o = 0;
    auto take = [&](size_t n) {
        float* p = base ? base + o : nullptr;
        o += (n + 3) & ~(size_t)3;
        return p;
    };
    const size_t Bs = (size_t)B, BL = Bs * d.latent;
    w.xa = take(Bs * d.ha); w.dca = take(Bs * d.ha); w.ad = take(Bs * d.ha); w.inva = take(d.ha);
    w.xb1 = take(Bs * d.hb1); w.dcb1 = take(Bs * d.hb1); w.bd1 = take(Bs * d.hb1);
    w.invb1 = take(d.hb1);
    w.xb2 = take(Bs * d.hb2); w.dcb2 = take(Bs * d.hb2); w.bd2 = take(Bs * d.hb2);
    w.invb2 = take(d.hb2);
    w.e = take(Bs * d.embed);
    w.mu = take(BL); w.lv = take(BL); w.epsv = take(BL); w.sigma = take(BL); w.z = take(BL);
    w.ra = take(Bs * d.da); w.rb1 = take(Bs * d.db1); w.rb2 = take(Bs * d.db2);
    w.rc = take(Bs * d.dc);
    w.drecon = take(Bs * d.a); w.dlogits_b = take(Bs * d.b); w.dlogits_c = take(Bs * d.sites);
    w.ce_rows = take(Bs);
    w.dua = take(Bs * d.da); w.dub2 = take(Bs * d.db2); w.dub1 = take(Bs * d.db1);
    w.duc = take(Bs * d.dc);
    w.dmh = take(BL); w.dlh = take(BL);
    w.daa = take(Bs * d.ha); w.dba2 = take(Bs * d.hb2); w.dba1 = take(Bs * d.hb1);
    w.part_mse = take(LOSS_BLOCKS); w.part_bce = take(LOSS_BLOCKS);
    // the largest split-K product's partial sums
    const int L = d.latent;
    const int shapes[15][3] = {{B, d.ha, d.a},    {B, d.hb1, d.b},   {B, d.hb2, d.hb1},
                               {B, d.da, L},      {B, d.a, d.da},    {B, d.db1, L},
                               {B, d.db2, d.db1}, {B, d.b, d.db2},   {B, d.dc, L},
                               {B, d.sites, d.dc}, {B, d.da, d.a},   {B, d.db2, d.b},
                               {B, d.db1, d.db2}, {B, d.dc, d.sites}, {B, d.hb1, d.hb2}};
    size_t scratch = 0;
    for (auto& s : shapes) {
        const Split sp = split_for(s[0], s[1], s[2], 1 << 20);
        scratch = max_sz(scratch, (size_t)sp.splits * s[0] * s[1]);
    }
    // one partial-sum scratch for each of up to three split products in flight
    w.scratch = take(scratch);
    w.scratch_b = take(scratch);
    w.scratch_c = take(scratch);
    long long off[N_PARAMS];
    w.grads = with_grads ? take((size_t)param_offsets(d, off)) : nullptr;
    w.total = o;
    return w;
}

// One step: forward, loss, every gradient, the new running stats of the
// three BatchNorms (bn_in/bn_out as bn_floats). a (B, in_a) is the RNA input
// and target, b (B, in_b) the DNA input and target. ``ea`` (or null) gives
// the seed, beta and gamma in place of the arguments (EpochArgs), ``step_at``
// (or null) the step index, as RNA->DNA's.
//
// 21 launches: the products of one phase that do not depend on each other
// (and the bias gradients' column sums) go out as one gemm_group_kernel, the
// three decoders' ReLU-masked upstream gradients as one relu_mask_group_kernel,
// the decoders' first layers (K = latent, not split) with their bias and
// ReLU inside the product; EncoderA's BatchNorm forward and EncoderB's first
// share one bn_forward_kernel, the three decoders' heads one mm_heads_kernel,
// and both encoders' last BN backward with their heads' (and the site
// embedding's) gradients one heads_backward_kernel. Each product and each
// column keeps its own code and order, so the arithmetic is that of one
// launch a phase.
int step_phases(const float* a, const float* b, const int64_t* site, const float* cw,
                const float* p, const Dims& d, int B, const float* bn_in, float* bn_out,
                const float* eps_in, const float* dropa_in, const float* dropb1_in,
                const float* dropb2_in, int noise, uint64_t seed, int step, const int* step_at,
                float beta, float gamma, const EpochArgs* ea, float* loss, float* g,
                const Work& w, const Queue& q) {
    long long off[N_PARAMS];
    param_offsets(d, off);
    const float* P[N_PARAMS];
    float* G[N_PARAMS];
    for (int i = 0; i < N_PARAMS; ++i) {
        P[i] = p + off[i];
        G[i] = g + off[i];
    }
    const int A = d.a, Bd = d.b, HA = d.ha, H1 = d.hb1, H2 = d.hb2, L = d.latent, S = d.sites;
    const int E = d.embed, DA = d.da, DB1 = d.db1, DB2 = d.db2, DC = d.dc;
    const int BIG = 1 << 20;
    int sp = 1, sp_b = 1, sp_c = 1;
    const float* bn_a_in = bn_in;
    const float* bn_b1_in = bn_in + 2 * HA;
    const float* bn_b2_in = bn_b1_in + 2 * H1;
    float* bn_a_out = bn_out;
    float* bn_b1_out = bn_out + 2 * HA;
    float* bn_b2_out = bn_b1_out + 2 * H1;

    // ---- forward: the three encoders ----
    {
        Group enc(q);
        enc.prod(Mat{a, A, 1}, Mat{P[A_W1], HA, 1}, w.scratch, B, HA, A, BIG, nullptr, &sp);
        enc.prod(Mat{b, Bd, 1}, Mat{P[B_W1], H1, 1}, w.scratch_b, B, H1, Bd, BIG, nullptr, &sp_b);
        CHECK(enc.launch());
    }
    CHECK(bn_forward(q,
                     BnForward{w.scratch, sp, B, HA, P[A_B1], P[A_G], P[A_BT], bn_a_in,
                               bn_a_in + HA, bn_a_out, bn_a_out + HA, dropa_in, noise, seed, ea,
                               step, step_at, STREAM_DROPOUT, w.xa, w.dca, w.ad, w.inva},
                     BnForward{w.scratch_b, sp_b, B, H1, P[B_B1], P[B_G1], P[B_BT1], bn_b1_in,
                               bn_b1_in + H1, bn_b1_out, bn_b1_out + H1, dropb1_in, noise, seed,
                               ea, step, step_at, STREAM_DROPOUT2, w.xb1, w.dcb1, w.bd1,
                               w.invb1}));
    CHECK(gemm(Mat{w.bd1, H1, 1}, Mat{P[B_W2], H2, 1}, w.scratch, B, H2, H1, BIG, q, &sp));
    CHECK(bn_forward(q, BnForward{w.scratch, sp, B, H2, P[B_B2], P[B_G2], P[B_BT2], bn_b2_in,
                                  bn_b2_in + H2, bn_b2_out, bn_b2_out + H2, dropb2_in, noise, seed,
                                  ea, step, step_at, STREAM_DROPOUT3, w.xb2, w.dcb2, w.bd2,
                                  w.invb2}));
    const Heads3 heads = {P[A_WMU], P[A_BMU], P[A_WLV], P[A_BLV], P[B_WMU], P[B_BMU], P[B_WLV],
                          P[B_BLV], P[EMB],   P[C_WMU], P[C_BMU], P[C_WLV], P[C_BLV]};
    CHECK(LAUNCH(q, posterior3_kernel, dim3(blocks((size_t)B * L, WARPS)), THREADS, w.ad, HA,
        w.bd2, H2, site, heads, B, L, S, E, eps_in, noise, seed, ea, step, step_at, w.e, w.mu,
        w.lv, w.epsv, w.sigma, w.z));

    // ---- forward: the three decoders and their heads ----
    {
        Group first(q);  // z . W + b through ReLU, for DecoderA, DecoderB and DecoderC
        first.prod(Mat{w.z, L, 1}, Mat{P[DA_W1], DA, 1}, w.ra, B, DA, L, 1, P[DA_B1], nullptr);
        first.prod(Mat{w.z, L, 1}, Mat{P[DB_W1], DB1, 1}, w.rb1, B, DB1, L, 1, P[DB_B1],
                   nullptr);
        first.prod(Mat{w.z, L, 1}, Mat{P[DC_W1], DC, 1}, w.rc, B, DC, L, 1, P[DC_B1], nullptr);
        CHECK(first.launch());
        Group second(q);
        second.prod(Mat{w.ra, DA, 1}, Mat{P[DA_W2], A, 1}, w.scratch, B, A, DA, BIG, nullptr,
                    &sp);
        second.prod(Mat{w.rb1, DB1, 1}, Mat{P[DB_W2], DB2, 1}, w.scratch_b, B, DB2, DB1, BIG,
                    nullptr, &sp_b);
        second.prod(Mat{w.rc, DC, 1}, Mat{P[DC_W2], S, 1}, w.scratch_c, B, S, DC, BIG, nullptr,
                    &sp_c);
        CHECK(second.launch());
    }
    {
        const MmHeads h{w.scratch, P[DA_B2], a, w.drecon, w.part_mse, w.scratch_b, P[DB_B2],
                        w.rb2, w.scratch_c, P[DC_B2], cw, site, gamma, ea, w.dlogits_c,
                        w.ce_rows, sp, sp_b, sp_c, B, A, DB2, S};
        const int total = LOSS_BLOCKS + blocks((size_t)B * DB2) + blocks(B, WARPS);
        CHECK(LAUNCH(q, mm_heads_kernel, dim3(total), THREADS, h));
    }
    CHECK(gemm(Mat{w.rb2, DB2, 1}, Mat{P[DB_W3], Bd, 1}, w.scratch, B, Bd, DB2, BIG, q, &sp));
    CHECK(LAUNCH(q, logits_kernel, dim3(LOSS_BLOCKS), THREADS, w.scratch, sp, B, Bd, P[DB_B3], b,
        w.dlogits_b, w.part_bce));
    CHECK(LAUNCH(q, loss_finish4_kernel, dim3(1), THREADS, w.part_mse, w.part_bce, LOSS_BLOCKS,
        w.ce_rows, B, w.mu, w.lv, B * L, beta, gamma, ea, loss));

    // ---- backward: the decoders' output layers, then DecoderB's middle one ----
    {
        Group out(q);  // dW = act^T . dy, db = column sums of dy, dx = dy . W^T (split)
        out.prod(Mat{w.ra, 1, DA}, Mat{w.drecon, A, 1}, G[DA_W2], DA, A, B, 1, nullptr, nullptr);
        out.prod(Mat{w.drecon, A, 1}, Mat{P[DA_W2], 1, A}, w.scratch, B, DA, A, BIG, nullptr,
                 &sp);
        out.prod(Mat{w.rb2, 1, DB2}, Mat{w.dlogits_b, Bd, 1}, G[DB_W3], DB2, Bd, B, 1, nullptr,
                 nullptr);
        out.prod(Mat{w.dlogits_b, Bd, 1}, Mat{P[DB_W3], 1, Bd}, w.scratch_b, B, DB2, Bd, BIG,
                 nullptr, &sp_b);
        out.prod(Mat{w.rc, 1, DC}, Mat{w.dlogits_c, S, 1}, G[DC_W2], DC, S, B, 1, nullptr,
                 nullptr);
        out.prod(Mat{w.dlogits_c, S, 1}, Mat{P[DC_W2], 1, S}, w.scratch_c, B, DC, S, BIG,
                 nullptr, &sp_c);
        out.colsum(w.drecon, B, A, G[DA_B2]);
        out.colsum(w.dlogits_b, B, Bd, G[DB_B3]);
        out.colsum(w.dlogits_c, B, S, G[DC_B2]);
        CHECK(out.launch());
        ReluMasks masks;
        masks.add(w.scratch, sp, B, DA, w.ra, w.dua);
        masks.add(w.scratch_b, sp_b, B, DB2, w.rb2, w.dub2);
        masks.add(w.scratch_c, sp_c, B, DC, w.rc, w.duc);
        CHECK(masks.launch(q));
        Group mid(q);
        mid.prod(Mat{w.rb1, 1, DB1}, Mat{w.dub2, DB2, 1}, G[DB_W2], DB1, DB2, B, 1, nullptr,
                 nullptr);
        mid.prod(Mat{w.dub2, DB2, 1}, Mat{P[DB_W2], 1, DB2}, w.scratch, B, DB1, DB2, BIG,
                 nullptr, &sp);
        mid.colsum(w.dub2, B, DB2, G[DB_B2]);
        CHECK(mid.launch());
    }
    CHECK(LAUNCH(q, epilogue_kernel, dim3(blocks((size_t)B * DB1)), THREADS, w.scratch, sp, B, DB1,
        nullptr, w.rb1, w.dub1, EPI_RELU_MASK));
    {
        Group first(q);  // the decoders' first layers: z^T . du and the column sums of du
        first.prod(Mat{w.z, 1, L}, Mat{w.dua, DA, 1}, G[DA_W1], L, DA, B, 1, nullptr, nullptr);
        first.prod(Mat{w.z, 1, L}, Mat{w.dub1, DB1, 1}, G[DB_W1], L, DB1, B, 1, nullptr,
                   nullptr);
        first.prod(Mat{w.z, 1, L}, Mat{w.duc, DC, 1}, G[DC_W1], L, DC, B, 1, nullptr, nullptr);
        first.colsum(w.dua, B, DA, G[DA_B1]);
        first.colsum(w.dub1, B, DB1, G[DB_B1]);
        first.colsum(w.duc, B, DC, G[DC_B1]);
        CHECK(first.launch());
    }

    // ---- backward: posterior, then EncoderA's block with its heads and the
    // site head and embedding in one launch, EncoderB's block 2 with its
    // heads (no site part: E = 0, S = 0, the bias written once a thread) in
    // another ----
    CHECK(LAUNCH(q, posterior3_backward_kernel, dim3(blocks((size_t)B * L, WARPS)), THREADS, w.dua,
        P[DA_W1], DA, w.dub1, P[DB_W1], DB1, w.duc, P[DC_W1], DC, B, L, w.mu, w.lv, w.epsv,
        w.sigma, beta, ea, w.dmh, w.dlh));
    HeadsBackward ha{};
    ha.dmh = w.dmh; ha.dlh = w.dlh; ha.wmu = P[A_WMU]; ha.wlv = P[A_WLV];
    ha.dcoef = w.dca; ha.xhat = w.xa; ha.inv_std = w.inva; ha.gamma = P[A_G];
    ha.d = w.ad; ha.e = w.e; ha.smu_w = P[C_WMU]; ha.slv_w = P[C_WLV]; ha.site = site;
    ha.da = w.daa; ha.g_gamma = G[A_G]; ha.g_beta = G[A_BT]; ha.g_b = G[A_B1]; ha.g_emb = G[EMB];
    ha.hg = HeadGrads{G[A_WMU], G[A_BMU], G[A_WLV], G[A_BLV],
                      G[C_WMU], G[C_BMU], G[C_WLV], G[C_BLV]};
    ha.B = B; ha.H = HA; ha.L = L; ha.S = S; ha.E = E;
    HeadsBackward hb{};
    hb.dmh = w.dmh; hb.dlh = w.dlh; hb.wmu = P[B_WMU]; hb.wlv = P[B_WLV];
    hb.dcoef = w.dcb2; hb.xhat = w.xb2; hb.inv_std = w.invb2; hb.gamma = P[B_G2];
    hb.d = w.bd2; hb.da = w.dba2; hb.g_gamma = G[B_G2]; hb.g_beta = G[B_BT2]; hb.g_b = G[B_B2];
    hb.hg = HeadGrads{G[B_WMU], G[B_BMU], G[B_WLV], G[B_BLV],
                      nullptr,  G[B_BMU], nullptr,  G[B_BLV]};
    hb.B = B; hb.H = H2; hb.L = L;
    CHECK(heads_backward(ha, q, hb));

    // ---- backward: EncoderA's and EncoderB's block 2 weights, EncoderB's block 1 ----
    {
        Group enc(q);
        enc.prod(Mat{a, 1, A}, Mat{w.daa, HA, 1}, G[A_W1], A, HA, B, 1, nullptr, nullptr);
        enc.prod(Mat{w.bd1, 1, H1}, Mat{w.dba2, H2, 1}, G[B_W2], H1, H2, B, 1, nullptr, nullptr);
        enc.prod(Mat{w.dba2, H2, 1}, Mat{P[B_W2], 1, H2}, w.scratch, B, H1, H2, BIG, nullptr,
                 &sp);
        CHECK(enc.launch());
    }
    CHECK(LAUNCH(q, bn_backward_kernel, dim3(blocks(H1, WARPS)), THREADS, w.scratch, sp, w.dcb1,
        w.xb1, w.invb1, P[B_G1], B, H1, w.dba1, G[B_G1], G[B_BT1], G[B_B1]));
    CHECK(gemm(Mat{b, 1, Bd}, Mat{w.dba1, H1, 1}, G[B_W1], Bd, H1, B, 1, q, nullptr));
    return 0;
}

// The epoch's launches on ``q``: for each step i, step_phases on rows
// [i * B, (i + 1) * B) with Philox step index i, then AdamW with step i's
// bias corrections; seed, beta, gamma, lr and wd come from ``ea``.
int epoch_phases(const float* a_ep, const float* b_ep, const int64_t* site_ep, const float* cw,
                 float* params, float* m, float* v, const Dims& d, int batch, int n_batches,
                 float* bn, const float* eps_ep, const float* dropa_ep, const float* dropb1_ep,
                 const float* dropb2_ep, int noise, const EpochArgs* ea, float* losses,
                 const Work& w, const Queue& q) {
    long long off[N_PARAMS];
    const long long n_params = param_offsets(d, off);
    const bool inj = noise == NOISE_INJECTED;
    for (int i = 0; i < n_batches; ++i) {
        const size_t r0 = (size_t)i * batch;
        CHECK(step_phases(a_ep + r0 * d.a, b_ep + r0 * d.b, site_ep + r0, cw, params, d, batch, bn,
                          bn, inj ? eps_ep + r0 * d.latent : nullptr,
                          inj ? dropa_ep + r0 * d.ha : nullptr,
                          inj ? dropb1_ep + r0 * d.hb1 : nullptr,
                          inj ? dropb2_ep + r0 * d.hb2 : nullptr, noise, 0, i, nullptr, 0.f, 0.f,
                          ea, losses + i, w.grads, w, q));
        CHECK(LAUNCH(q, adamw_kernel, dim3(blocks((size_t)n_params)), THREADS, params, m, v,
            w.grads, n_params, 0.f, 0.f, 1.f, 1.f, ea, i));
    }
    return 0;
}

bool noise_ok(int noise, const float* eps, const float* da, const float* db1, const float* db2) {
    if (noise == NOISE_PHILOX) return true;
    return noise == NOISE_INJECTED && eps && da && db1 && db2;
}

}  // namespace mm

// A captured graph (an epoch of any task, or a step of the DNA->RNA or the
// tri-modal model) and the stream it was captured on. An epoch replays on that
// stream, ordered after the caller's stream by ``ready`` and the caller after
// it by ``done``; a step replays on the caller's stream, records ``done``
// there after each launch, and keeps its template graph and that graph's
// first node (step_args_kernel), whose arguments each launch sets
// (step_graph_launch), and the device StepArgs the node writes. Either way
// ``done`` follows the last launch. ``nodes``: the kernel launches the graph
// holds.
struct Graph {
    cudaStream_t stream = nullptr;
    cudaEvent_t ready = nullptr, done = nullptr;
    cudaGraph_t graph = nullptr;
    cudaGraphExec_t exec = nullptr;
    cudaGraphNode_t args_node = nullptr;
    StepArgs* args = nullptr;
    size_t nodes = 0;
};

void free_graph(Graph* g) {
    if (g->done) cudaEventSynchronize(g->done);
    if (g->exec) cudaGraphExecDestroy(g->exec);
    if (g->graph) cudaGraphDestroy(g->graph);
    if (g->ready) cudaEventDestroy(g->ready);
    if (g->done) cudaEventDestroy(g->done);
    if (g->stream) cudaStreamDestroy(g->stream);
    delete g;
}

// The one root of a captured step, which must be step_args_kernel's node.
int args_node(cudaGraph_t graph, cudaGraphNode_t* node) {
    size_t n = 0;
    CHECK(cudaGraphGetRootNodes(graph, nullptr, &n));
    if (n != 1) return (int)cudaErrorInvalidValue;
    CHECK(cudaGraphGetRootNodes(graph, node, &n));
    cudaGraphNodeType type;
    CHECK(cudaGraphNodeGetType(*node, &type));
    return type == cudaGraphNodeTypeKernel ? 0 : (int)cudaErrorInvalidValue;
}

// Capture what ``enqueue(stream)`` launches into a CUDA graph, on a
// non-blocking stream of its own (so the caller's stream may be the legacy
// default one), and instantiate it; with ``step_args``, a step_args_kernel
// writing there goes first. Returns the graph, or null with *err set to the
// first CUDA error of the capture, the enqueue or the instantiation.
template <class Enqueue>
void* capture(Enqueue enqueue, int* err, StepArgs* step_args = nullptr) {
    auto* g = new Graph;
    auto fail = [&](int e) -> void* {
        *err = e;
        free_graph(g);
        return nullptr;
    };
    int e = (int)cudaStreamCreateWithFlags(&g->stream, cudaStreamNonBlocking);
    if (!e) e = (int)cudaEventCreateWithFlags(&g->ready, cudaEventDisableTiming);
    if (!e) e = (int)cudaEventCreateWithFlags(&g->done, cudaEventDisableTiming);
    if (!e) e = (int)cudaStreamBeginCapture(g->stream, cudaStreamCaptureModeThreadLocal);
    if (e) return fail(e);
    int enq = 0;
    if (step_args) {
        step_args_kernel<<<1, 1, 0, g->stream>>>(StepArgs{}, step_args);
        enq = (int)cudaGetLastError();
    }
    if (!enq) enq = enqueue(g->stream);
    cudaGraph_t graph = nullptr;
    const int ended = (int)cudaStreamEndCapture(g->stream, &graph);
    e = enq ? enq : ended;
    if (step_args) {
        g->graph = graph;  // the args node's template: freed with g
        g->args = step_args;
    }
    if (!e) e = (int)cudaGraphGetNodes(graph, nullptr, &g->nodes);
    if (!e && step_args) e = args_node(graph, &g->args_node);
    if (!e) e = (int)cudaGraphInstantiate(&g->exec, graph, 0);
    if (!step_args && graph) cudaGraphDestroy(graph);
    if (e) return fail(e);
    return g;
}

}  // namespace

extern "C" {

// Floats in one parameter buffer (the 19 tensors of PARAM_ORDER, flat, in
// that order). dims: in, hidden, latent, sites, embed, d1, d2, out.
long long rna2dna_param_count(const int* dims) {
    long long off[N_PARAMS];
    return param_offsets(dims_from(dims), off);
}

// Floats of device workspace a step (with_grads 0) or an epoch (with_grads 1,
// which adds one gradient buffer) needs at this batch size.
long long rna2dna_train_workspace_floats(const int* dims, int batch, int with_grads) {
    return (long long)plan(nullptr, dims_from(dims), batch, with_grads != 0).total;
}

// Floats of the epoch-args buffer of an epoch of n_batches steps (any task):
// struct EpochArgs (seed as two floats' worth of bytes, beta, gamma, lr, wd),
// then (bc1, bc2) of each step.
int epoch_args_floats(int n_batches) {
    return (int)(sizeof(EpochArgs) / sizeof(float)) + 2 * n_batches;
}

// Capture one RNA->DNA epoch of n_batches steps into a CUDA graph and
// instantiate it: the rows x_ep (n_batches * B, in), t_ep (n_batches * B,
// out), site_ep, the injected noise (eps_ep, drop_ep) when noise == 0,
// params, m, v (flat buffers), bn (rm then rv, 2 * hidden), losses
// (n_batches,), work (rna2dna_train_workspace_floats(dims, B, 1)) and args
// (epoch_args_floats(n_batches) floats: the seed, beta, lr, wd and each
// step's bias corrections, read when the graph runs; gamma unused) are baked
// in by address: each launch of the graph (epoch_graph_launch) runs the
// epoch on what these buffers hold then, updating params, m, v and bn in
// place. Step i draws its noise with step index i. pdl: 1 launches the
// phases programmatically, 0 as plain stream launches (the same bits; the
// wrapper's choice, fused_epoch._EpochGraph). Returns a handle, or null with
// *err set.
void* rna2dna_epoch_graph_create(const float* x_ep, const float* t_ep, const int64_t* site_ep,
                                 float* params, float* m, float* v, const int* dims, int batch,
                                 int n_batches, float* bn, const float* eps_ep,
                                 const float* drop_ep, int noise, const float* args,
                                 float* losses, float* work, int pdl, int* err) {
    const Dims d = dims_from(dims);
    *err = 0;
    if (!valid(d, batch) || n_batches < 1 || !args ||
        (noise == NOISE_INJECTED && (!eps_ep || !drop_ep)) ||
        (noise != NOISE_INJECTED && noise != NOISE_PHILOX)) {
        *err = (int)cudaErrorInvalidValue;
        return nullptr;
    }
    const Work w = plan(work, d, batch, true);
    const EpochArgs* ea = reinterpret_cast<const EpochArgs*>(args);
    return capture([&](cudaStream_t st) {
        return epoch_phases(x_ep, t_ep, site_ep, params, m, v, d, batch, n_batches, bn, eps_ep,
                            drop_ep, noise, ea, losses, w, Queue{st, pdl != 0});
    }, err);
}

// Capture one RNA->DNA train step into a CUDA graph and instantiate it, as
// dna2rna_step_graph_create: x (B, in) the RNA input, t (B, out) the DNA
// target, site (B,) int64, params (the flat parameter buffer), bn_in (rm
// then rv, 2 * hidden), eps_in (B, latent) and drop_in (B, hidden) when noise
// == 0 (NOISE_INJECTED; ignored when 1, Philox), the outputs bn_out (as
// bn_in), loss (1,) and grads (like params), work
// (rna2dna_train_workspace_floats(dims, B, 0) floats) and args (8 floats,
// struct StepArgs). pdl as for dna2rna_step_graph_create. Returns a handle,
// or null with *err set.
void* rna2dna_step_graph_create(const float* x, const float* t, const int64_t* site,
                                const float* params, const int* dims, int batch,
                                const float* bn_in, float* bn_out, const float* eps_in,
                                const float* drop_in, int noise, float* args, float* loss,
                                float* grads, float* work, int pdl, int* err) {
    const Dims d = dims_from(dims);
    *err = 0;
    if (!valid(d, batch) || !args || (noise == NOISE_INJECTED && (!eps_in || !drop_in)) ||
        (noise != NOISE_INJECTED && noise != NOISE_PHILOX)) {
        *err = (int)cudaErrorInvalidValue;
        return nullptr;
    }
    long long off[N_PARAMS];
    const float* end = params + param_offsets(d, off);
    const Work w = plan(work, d, batch, false);
    StepArgs* sa = reinterpret_cast<StepArgs*>(args);
    return capture([&](cudaStream_t st) {
        return step_phases(x, t, site, params, d, batch, bn_in, bn_in + d.hid, bn_out,
                           bn_out + d.hid, eps_in, drop_in, noise, 0, 0, &sa->step, 0.f, &sa->e,
                           loss, grads, w, Queue{st, pdl != 0, params, end});
    }, err, sa);
}

// The dropout mask (B, hidden) and eps (B, latent) that a step at (seed,
// step) draws in NOISE_PHILOX mode.
int rna2dna_train_noise(unsigned long long seed, int step, int batch, int hidden, int latent,
                        float* keep, float* eps, void* stream) {
    if (batch < 1 || hidden < 1 || latent < 1) return (int)cudaErrorInvalidValue;
    const size_t n = (size_t)batch * (hidden > latent ? hidden : latent);
    noise_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        (uint64_t)seed, step, batch, hidden, STREAM_DROPOUT, latent, keep, eps);
    return (int)cudaGetLastError();
}

// ---- DNA->RNA ------------------------------------------------------------

// Floats in one DNA->RNA parameter buffer (the 21 tensors of
// PARAM_ORDER_D2R). dims: in, h1, h2, latent, sites, embed, d1, out.
long long dna2rna_param_count(const int* dims) {
    long long off[d2r::N_PARAMS];
    return d2r::param_offsets(d2r::from(dims), off);
}

// Floats of device workspace a DNA->RNA step (with_grads 0) or epoch
// (with_grads 1) needs at this batch size.
long long dna2rna_train_workspace_floats(const int* dims, int batch, int with_grads) {
    return (long long)d2r::plan(nullptr, d2r::from(dims), batch, with_grads != 0).total;
}

// Capture one DNA->RNA train step into a CUDA graph and instantiate it. Its
// buffers are baked in by address: x (B, in) the DNA input, t (B, out) the
// RNA target, site (B,) int64, params (the flat parameter buffer), bn_in
// (rm1, rv1 (h1), rm2, rv2 (h2)), eps_in (B, latent), drop1_in (B, h1) and
// drop2_in (B, h2) when noise == 0 (NOISE_INJECTED; ignored when 1, Philox),
// and the outputs bn_out (as bn_in), loss (1,) and grads (like params), work
// (dna2rna_train_workspace_floats(dims, B, 0) floats) and args (8 floats,
// struct StepArgs: the seed, beta and the Philox step index, which each
// step_graph_launch sets). Each launch runs the step on what the buffers
// hold then. pdl as for rna2dna_epoch_graph_create; with 1 a product fetches
// its first parameter tile before it waits (nothing in the graph writes
// params). Returns a handle, or null with *err set.
void* dna2rna_step_graph_create(const float* x, const float* t, const int64_t* site,
                                const float* params, const int* dims, int batch,
                                const float* bn_in, float* bn_out, const float* eps_in,
                                const float* drop1_in, const float* drop2_in, int noise,
                                float* args, float* loss, float* grads, float* work, int pdl,
                                int* err) {
    const d2r::Dims d = d2r::from(dims);
    *err = 0;
    if (!d2r::valid(d, batch) || !args ||
        (noise == NOISE_INJECTED && (!eps_in || !drop1_in || !drop2_in)) ||
        (noise != NOISE_INJECTED && noise != NOISE_PHILOX)) {
        *err = (int)cudaErrorInvalidValue;
        return nullptr;
    }
    long long off[d2r::N_PARAMS];
    const float* end = params + d2r::param_offsets(d, off);
    const d2r::Work w = d2r::plan(work, d, batch, false);
    StepArgs* sa = reinterpret_cast<StepArgs*>(args);
    return capture([&](cudaStream_t st) {
        return d2r::step_phases(x, t, site, params, d, batch, bn_in, bn_out, eps_in, drop1_in,
                                drop2_in, noise, 0, 0, &sa->step, 0.f, &sa->e, loss, grads, w,
                                Queue{st, pdl != 0, params, end});
    }, err, sa);
}

// Capture one DNA->RNA epoch into a CUDA graph, as rna2dna_epoch_graph_create:
// x_ep (n_batches * B, in) the DNA input, t_ep the RNA target, the injected
// noise (eps_ep, drop1_ep, drop2_ep) when noise == 0, bn (rm1, rv1, rm2,
// rv2) and work (dna2rna_train_workspace_floats(dims, B, 1)).
void* dna2rna_epoch_graph_create(const float* x_ep, const float* t_ep, const int64_t* site_ep,
                                 float* params, float* m, float* v, const int* dims, int batch,
                                 int n_batches, float* bn, const float* eps_ep,
                                 const float* drop1_ep, const float* drop2_ep, int noise,
                                 const float* args, float* losses, float* work, int pdl,
                                 int* err) {
    const d2r::Dims d = d2r::from(dims);
    *err = 0;
    if (!d2r::valid(d, batch) || n_batches < 1 || !args ||
        (noise == NOISE_INJECTED && (!eps_ep || !drop1_ep || !drop2_ep)) ||
        (noise != NOISE_INJECTED && noise != NOISE_PHILOX)) {
        *err = (int)cudaErrorInvalidValue;
        return nullptr;
    }
    const d2r::Work w = d2r::plan(work, d, batch, true);
    const EpochArgs* ea = reinterpret_cast<const EpochArgs*>(args);
    return capture([&](cudaStream_t st) {
        return d2r::epoch_phases(x_ep, t_ep, site_ep, params, m, v, d, batch, n_batches, bn,
                                 eps_ep, drop1_ep, drop2_ep, noise, ea, losses, w, Queue{st, pdl != 0});
    }, err);
}

// The dropout masks (B, h1), (B, h2) and eps (B, latent) that a DNA->RNA
// step at (seed, step) draws in NOISE_PHILOX mode.
int dna2rna_train_noise(unsigned long long seed, int step, int batch, int h1, int h2, int latent,
                        float* keep1, float* keep2, float* eps, void* stream) {
    if (batch < 1 || h1 < 1 || h2 < 1 || latent < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const size_t n = (size_t)batch * (h1 > latent ? h1 : latent);
    noise_kernel<<<blocks(n), THREADS, 0, st>>>((uint64_t)seed, step, batch, h1, STREAM_DROPOUT,
                                                latent, keep1, eps);
    LAUNCHED();
    noise_kernel<<<blocks((size_t)batch * h2), THREADS, 0, st>>>(
        (uint64_t)seed, step, batch, h2, STREAM_DROPOUT2, 0, keep2, nullptr);
    return (int)cudaGetLastError();
}

// ---- MultiModalVAE ---------------------------------------------------------

// Floats in one tri-modal parameter buffer (the 39 tensors of
// PARAM_ORDER_MM). dims: in_a, in_b, ha, hb1, hb2, latent, sites, embed, da,
// db1, db2, dc.
long long multimodal_param_count(const int* dims) {
    long long off[mm::N_PARAMS];
    return mm::param_offsets(mm::from(dims), off);
}

// Floats of device workspace a tri-modal step (with_grads 0) or epoch
// (with_grads 1) needs at this batch size.
long long multimodal_train_workspace_floats(const int* dims, int batch, int with_grads) {
    return (long long)mm::plan(nullptr, mm::from(dims), batch, with_grads != 0).total;
}

// Capture one tri-modal train step into a CUDA graph and instantiate it, as
// dna2rna_step_graph_create: a (B, in_a) RNA and b (B, in_b) DNA, each both
// an input and a target; site (B,) int64 in [0, sites); cw (sites,) class
// weights or null for ones; params; bn_in/bn_out: a_rm, a_rv, b_rm1, b_rv1,
// b_rm2, b_rv2; eps_in (B, latent), dropa_in (B, ha), dropb1_in (B, hb1),
// dropb2_in (B, hb2) when noise == 0; loss, grads, work
// (multimodal_train_workspace_floats(dims, B, 0) floats) and args (StepArgs:
// the seed, beta, gamma and the Philox step index).
void* multimodal_step_graph_create(const float* a, const float* b, const int64_t* site,
                                   const float* cw, const float* params, const int* dims,
                                   int batch, const float* bn_in, float* bn_out,
                                   const float* eps_in, const float* dropa_in,
                                   const float* dropb1_in, const float* dropb2_in, int noise,
                                   float* args, float* loss, float* grads, float* work, int pdl,
                                   int* err) {
    const mm::Dims d = mm::from(dims);
    *err = 0;
    if (!mm::valid(d, batch) || !args ||
        !mm::noise_ok(noise, eps_in, dropa_in, dropb1_in, dropb2_in)) {
        *err = (int)cudaErrorInvalidValue;
        return nullptr;
    }
    long long off[mm::N_PARAMS];
    const float* end = params + mm::param_offsets(d, off);
    const mm::Work w = mm::plan(work, d, batch, false);
    StepArgs* sa = reinterpret_cast<StepArgs*>(args);
    return capture([&](cudaStream_t st) {
        return mm::step_phases(a, b, site, cw, params, d, batch, bn_in, bn_out, eps_in, dropa_in,
                               dropb1_in, dropb2_in, noise, 0, 0, &sa->step, 0.f, 0.f, &sa->e,
                               loss, grads, w, Queue{st, pdl != 0, params, end});
    }, err, sa);
}

// Capture one tri-modal epoch of n_batches steps into a CUDA graph and
// instantiate it: the rows a_ep (n_batches * B, in_a), b_ep, site_ep, the
// injected noise (eps_ep, dropa_ep, dropb1_ep, dropb2_ep) when noise == 0,
// cw (or null), params, m, v (flat buffers), bn (as the step's), losses
// (n_batches,), work (multimodal_train_workspace_floats(dims, B, 1)) and
// args (epoch_args_floats(n_batches) floats: the seed, beta,
// gamma, lr, wd and each step's bias corrections, read when the graph runs)
// are baked in by address: each launch of the graph runs the epoch on what
// these buffers hold then, updating params, m, v and bn in place. Step i
// draws its noise with step index i (capture). Returns a handle for
// epoch_graph_launch, or null with *err set.
void* multimodal_epoch_graph_create(const float* a_ep, const float* b_ep, const int64_t* site_ep,
                                    const float* cw, float* params, float* m, float* v,
                                    const int* dims, int batch, int n_batches, float* bn,
                                    const float* eps_ep, const float* dropa_ep,
                                    const float* dropb1_ep, const float* dropb2_ep, int noise,
                                    const float* args, float* losses, float* work, int pdl,
                                    int* err) {
    const mm::Dims d = mm::from(dims);
    *err = 0;
    if (!mm::valid(d, batch) || n_batches < 1 || !args ||
        !mm::noise_ok(noise, eps_ep, dropa_ep, dropb1_ep, dropb2_ep)) {
        *err = (int)cudaErrorInvalidValue;
        return nullptr;
    }
    const mm::Work w = mm::plan(work, d, batch, true);
    const EpochArgs* ea = reinterpret_cast<const EpochArgs*>(args);
    return capture([&](cudaStream_t st) {
        return mm::epoch_phases(a_ep, b_ep, site_ep, cw, params, m, v, d, batch, n_batches, bn,
                                eps_ep, dropa_ep, dropb1_ep, dropb2_ep, noise, ea, losses, w, Queue{st, pdl != 0});
    }, err);
}

// Replay a captured epoch (of any task): after what the caller's stream has
// queued, and before what it queues next.
int epoch_graph_launch(void* handle, void* stream) {
    auto* g = static_cast<Graph*>(handle);
    cudaStream_t caller = (cudaStream_t)stream;
    CHECK(cudaEventRecord(g->ready, caller));
    CHECK(cudaStreamWaitEvent(g->stream, g->ready, 0));
    CHECK(cudaGraphLaunch(g->exec, g->stream));
    CHECK(cudaEventRecord(g->done, g->stream));
    CHECK(cudaStreamWaitEvent(caller, g->done, 0));
    return 0;
}

// Replay a captured step on the caller's stream with ``args`` (a host
// StepArgs: the seed, beta, gamma and step index, fused_train.step_args),
// which the graph's first node writes to the device buffer its phases read.
// Setting that node's arguments affects this launch and later ones, never one
// already queued, so the host buffer is free on return.
int step_graph_launch(void* handle, const void* args, void* stream) {
    auto* g = static_cast<Graph*>(handle);
    StepArgs a;
    memcpy(&a, args, sizeof a);
    void* params[] = {&a, &g->args};
    cudaKernelNodeParams p = {};
    p.func = (void*)step_args_kernel;
    p.gridDim = dim3(1);
    p.blockDim = dim3(1);
    p.kernelParams = params;
    CHECK(cudaGraphExecKernelNodeSetParams(g->exec, g->args_node, &p));
    CHECK(cudaGraphLaunch(g->exec, (cudaStream_t)stream));
    CHECK(cudaEventRecord(g->done, (cudaStream_t)stream));
    return 0;
}

// Kernel launches in a captured graph (an epoch's or a step's).
long long graph_nodes(void* handle) { return (long long)static_cast<Graph*>(handle)->nodes; }

// Free a captured graph, after its last launch has run.
void graph_destroy(void* handle) {
    if (handle) free_graph(static_cast<Graph*>(handle));
}

// The dropout masks (B, ha), (B, hb1), (B, hb2) and eps (B, latent) that a
// tri-modal step at (seed, step) draws in NOISE_PHILOX mode.
int multimodal_train_noise(unsigned long long seed, int step, int batch, int ha, int hb1,
                           int hb2, int latent, float* keep_a, float* keep_b1, float* keep_b2,
                           float* eps, void* stream) {
    if (batch < 1 || ha < 1 || hb1 < 1 || hb2 < 1 || latent < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const size_t n = (size_t)batch * (ha > latent ? ha : latent);
    noise_kernel<<<blocks(n), THREADS, 0, st>>>((uint64_t)seed, step, batch, ha, STREAM_DROPOUT,
                                                latent, keep_a, eps);
    LAUNCHED();
    noise_kernel<<<blocks((size_t)batch * hb1), THREADS, 0, st>>>(
        (uint64_t)seed, step, batch, hb1, STREAM_DROPOUT2, 0, keep_b1, nullptr);
    LAUNCHED();
    noise_kernel<<<blocks((size_t)batch * hb2), THREADS, 0, st>>>(
        (uint64_t)seed, step, batch, hb2, STREAM_DROPOUT3, 0, keep_b2, nullptr);
    return (int)cudaGetLastError();
}

const char* fused_train_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
