// RNA->DNA directional-VAE training step and whole epoch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels
//   * rna2dna_train_step  <- vae_los_angeles_tpu/ops/pallas/fused_train.py
//                            _train_kernel / _train_step_call (rna2dna_fused_train_step)
//   * rna2dna_train_epoch <- vae_los_angeles_tpu/ops/pallas/fused_epoch.py
//                            _epoch_kernel / _epoch_call (rna2dna_fused_epoch)
//
// One step computes what the TPU kernel computes: the train-mode forward
// (Linear -> batch-statistics BatchNorm -> ReLU -> dropout(0.1) -> mu/logvar
// heads; the site embedding's heads; arithmetic-mean fusion; z = mu + eps *
// exp(logvar / 2); decoder latent -> d1 -> d2 -> out logits), the loss
// BCE-with-logits sum + beta * KLD, the hand-derived gradients of all 19
// tensors of PARAM_ORDER (ops/kernels/fused_train.py) and the BatchNorm
// running statistics (biased variance to normalise, unbiased to track,
// momentum 0.1). The epoch runs n_batches such steps, each followed by the
// torch-order AdamW update (decay first, bias correction at step0 + i + 1)
// of one flat buffer holding all 19 tensors of p, m and v.
//
// What bounds it on an H100: a step at B = 32 is ~166 MFLOP of fp32 against
// ~7.6 MB of parameters in and gradients out, so 2.5 us of FMA at 67 TFLOP/s
// and 2.3 us of memory at 3.35 TB/s. What the simple design below actually
// pays is latency: ~26 dependent launches a step (~97 us of kernels, and the
// host's enqueue of the launches, at ~130 us a step in an epoch), with the
// parameters and moments (11 MB) resident in the 50 MB L2.
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
//   * The loss is summed per block in a fixed tree, then by one block over
//     the block sums.
//   * The embedding gradient (the TPU computes one_hot^T . de) gives one
//     thread one (site, column) cell and adds the rows with that site in row
//     order; a label outside [0, sites) matches no cell and gathers a zero
//     row, as the one-hot does.
//   * Noise: NOISE_INJECTED reads the caller's eps (B, latent) and dropout
//     mask (B, hidden); NOISE_PHILOX draws them from Philox4x32-10 keyed by the
//     64-bit seed, with the counter (row, column, step, stream), stream 0 for
//     dropout (keep iff a 24-bit uniform < 0.9) and 1 for eps (Box-Muller).
//   * The epoch is one C entry: a host loop over the steps that enqueues each
//     step's phases and the AdamW kernel on the caller's stream. Python crosses
//     into C once an epoch.
//
// Plain C interface, built with nvcc into a shared library and called through
// ctypes (ops/kernels/_build.py, fused_train.py, fused_epoch.py). Every entry
// point launches on the caller's stream, allocates nothing, and returns the
// first CUDA error (cudaGetLastError after each launch).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
constexpr int LOSS_BLOCKS = 64;
constexpr int THREADS = 256;

enum NoiseMode { NOISE_INJECTED = 0, NOISE_PHILOX = 1 };
enum Stream { STREAM_DROPOUT = 0, STREAM_EPS = 1 };
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
__device__ __forceinline__ float philox_keep(uint64_t seed, int row, int col, int step) {
    const uint32_t bits = philox_bits(seed, row, col, step, STREAM_DROPOUT).x;
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
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const float* __restrict__ a, int a0, int a1, const float* __restrict__ b, int b0,
            int b1, float* __restrict__ c, int M, int N, int K, int kchunk) {
    __shared__ float As[TILE][TILE + 1];  // As[k][i]
    __shared__ float Bs[TILE][TILE + 1];  // Bs[k][j]
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
    const int kbeg = blockIdx.z * kchunk;
    const int kend = min(K, kbeg + kchunk);
    float acc00 = 0.f, acc01 = 0.f, acc10 = 0.f, acc11 = 0.f;
    for (int k0 = kbeg; k0 < kend; k0 += TILE) {
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
#pragma unroll 8
        for (int kk = 0; kk < TILE; ++kk) {
            const float x0 = As[kk][ty], x1 = As[kk][ty + 16];
            const float y0 = Bs[kk][tx], y1 = Bs[kk][tx + 16];
            acc00 = fmaf(x0, y0, acc00);
            acc01 = fmaf(x0, y1, acc01);
            acc10 = fmaf(x1, y0, acc10);
            acc11 = fmaf(x1, y1, acc11);
        }
        __syncthreads();
    }
    float* cz = c + (size_t)blockIdx.z * M * N;
    const int ia = i0 + ty, ib = i0 + ty + 16, ja = j0 + tx, jb = j0 + tx + 16;
    if (ia < M && ja < N) cz[(size_t)ia * N + ja] = acc00;
    if (ia < M && jb < N) cz[(size_t)ia * N + jb] = acc01;
    if (ib < M && ja < N) cz[(size_t)ib * N + ja] = acc10;
    if (ib < M && jb < N) cz[(size_t)ib * N + jb] = acc11;
}

struct Split {
    int splits, kchunk;
};

// Fixed split of the reduction index: enough blocks for the card, chunks of
// whole 32-wide steps. Depends on the shapes only.
Split split_for(int M, int N, int K, int max_splits) {
    const int tiles = ((M + TILE - 1) / TILE) * ((N + TILE - 1) / TILE);
    const int ktiles = (K + TILE - 1) / TILE;
    int want = (SPLIT_TARGET + tiles - 1) / tiles;
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

int gemm(Mat A, Mat B, float* C, int M, int N, int K, int max_splits, cudaStream_t st,
         int* splits_out) {
    const Split s = split_for(M, N, K, max_splits);
    const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE, s.splits);
    gemm_kernel<<<grid, GEMM_THREADS, 0, st>>>(A.p, A.s0, A.s1, B.p, B.s0, B.s1, C, M, N, K,
                                                s.kchunk);
    if (splits_out) *splits_out = s.splits;
    return (int)cudaGetLastError();
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

// Encoder BatchNorm (train mode), ReLU and dropout: one warp per column, its
// lanes over the rows.
__global__ void __launch_bounds__(THREADS)
bn_forward_kernel(const float* __restrict__ part, int splits, int B, int H,
                  const float* __restrict__ b1, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const float* rm_in, const float* rv_in,
                  float* rm_out, float* rv_out, const float* __restrict__ drop_in, int noise,
                  uint64_t seed, int step, float* __restrict__ xhat, float* __restrict__ dcoef,
                  float* __restrict__ d, float* __restrict__ inv_std) {
    const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (j >= H) return;  // warp-uniform
    const size_t mn = (size_t)B * H;
    float sum = 0.f;
    for (int r = lane; r < B; r += 32) {
        const float a = sum_splits(part, splits, mn, (size_t)r * H + j) + b1[j];
        xhat[(size_t)r * H + j] = a;  // a1 for now
        sum += a;
    }
    const float mean = warp_sum(sum) / (float)B;
    float sq = 0.f;
    for (int r = lane; r < B; r += 32) {
        const float c = xhat[(size_t)r * H + j] - mean;
        sq += c * c;
    }
    const float var = warp_sum(sq) / (float)B;
    const float inv = rsqrtf(var + BN_EPS);
    const float g = gamma[j], bb = beta[j];
    for (int r = lane; r < B; r += 32) {
        const size_t i = (size_t)r * H + j;
        const float xh = (xhat[i] - mean) * inv;
        const float h = xh * g + bb;
        const float keep = noise == NOISE_PHILOX ? philox_keep(seed, r, j, step) : drop_in[i];
        const float coef = h > 0.f ? keep / KEEP : 0.f;
        xhat[i] = xh;
        dcoef[i] = coef;
        d[i] = h * coef;
    }
    if (lane == 0) {
        inv_std[j] = inv;
        const float unbias = (float)B / (float)(B > 1 ? B - 1 : 1);
        rm_out[j] = (1.0f - BN_MOMENTUM) * rm_in[j] + BN_MOMENTUM * mean;
        rv_out[j] = (1.0f - BN_MOMENTUM) * rv_in[j] + BN_MOMENTUM * var * unbias;
    }
}

struct Heads {
    const float *wmu, *bmu, *wlv, *blv, *emb, *smu_w, *smu_b, *slv_w, *slv_b;
};

// Posterior heads, site gather, fusion and z: one warp per (row, latent
// index), its lanes over the heads' input index; the grid's threads also
// store the gathered embedding rows.
__global__ void __launch_bounds__(THREADS)
posterior_kernel(const float* __restrict__ d, const int64_t* __restrict__ site, Heads w,
                 int B, int H, int L, int S, int E, const float* __restrict__ eps_in, int noise,
                 uint64_t seed, int step, float* __restrict__ e, float* __restrict__ mu,
                 float* __restrict__ lv, float* __restrict__ epsv, float* __restrict__ sigma,
                 float* __restrict__ z) {
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
    const float ep = noise == NOISE_PHILOX ? philox_normal(seed, r, j, step) : eps_in[idx];
    const float sg = expf(0.5f * v);
    mu[idx] = m;
    lv[idx] = v;
    epsv[idx] = ep;
    sigma[idx] = sg;
    z[idx] = m + ep * sg;
}

// out = relu(sum of partials + bias), or out = sum of partials where ref > 0.
__global__ void epilogue_kernel(const float* __restrict__ part, int splits, int M, int N,
                                const float* __restrict__ bias, const float* __restrict__ ref,
                                float* __restrict__ out, int mode) {
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
__global__ void __launch_bounds__(THREADS)
logits_kernel(const float* __restrict__ acc_part, int splits, int B, int O,
              const float* __restrict__ bias, const float* __restrict__ t,
              float* __restrict__ dlogits, float* __restrict__ part) {
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

// loss = sum of the block sums + beta * KLD, one block.
__global__ void __launch_bounds__(THREADS)
loss_finish_kernel(const float* __restrict__ part, int n_part, const float* __restrict__ mu,
                   const float* __restrict__ lv, int n_lat, float beta, float* loss) {
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
    if (threadIdx.x == 0) *loss = rb[0] + beta * (-0.5f * rk[0]);
}

// out[j] = sum over rows of y[r][j]: one thread per column.
__global__ void colsum_kernel(const float* __restrict__ y, int M, int N, float* __restrict__ out) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= N) return;
    float s = 0.f;
    for (int r = 0; r < M; ++r) s += y[(size_t)r * N + j];
    out[j] = s;
}

// dz = du1 . d1w^T, then the posterior's backward: dmu/2 and dlogvar/2
// (each of the two fused posteriors takes half). One warp per (row, j), its
// lanes over d1.
__global__ void __launch_bounds__(THREADS)
posterior_backward_kernel(const float* __restrict__ du1, const float* __restrict__ d1w, int B,
                          int D1, int L, const float* __restrict__ mu,
                          const float* __restrict__ lv, const float* __restrict__ epsv,
                          const float* __restrict__ sigma, float beta, float* __restrict__ dmh,
                          float* __restrict__ dlh) {
    const int idx = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (idx >= B * L) return;  // warp-uniform
    const int r = idx / L, j = idx - r * L;
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

// Gradients of the four posterior heads: one thread per output element,
// each summing its B rows in order.
__global__ void head_grads_kernel(const float* __restrict__ d, const float* __restrict__ e,
                                  const float* __restrict__ dmh, const float* __restrict__ dlh,
                                  int B, int H, int E, int L, HeadGrads g) {
    int idx = blockIdx.x * blockDim.x + threadIdx.x;
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
// de = dmh . smu_w^T + dlh . slv_w^T computed for the matching rows only.
__global__ void emb_grad_kernel(const int64_t* __restrict__ site, const float* __restrict__ dmh,
                                const float* __restrict__ dlh, const float* __restrict__ smu_w,
                                const float* __restrict__ slv_w, int B, int S, int E, int L,
                                float* __restrict__ g_emb) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
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

// dd = dmh . wmu^T + dlh . wlv^T, dh = dd * relu mask * dropout / keep, and
// train-mode BatchNorm's backward, one warp per column, its lanes over the
// rows: dgamma, dbeta, da1 = inv_std * (dxhat - mean(dxhat) - xhat *
// mean(dxhat * xhat)) and the encoder bias gradient sum(da1).
__global__ void __launch_bounds__(THREADS)
bn_backward_kernel(const float* __restrict__ dmh, const float* __restrict__ dlh,
                   const float* __restrict__ wmu, const float* __restrict__ wlv,
                   const float* __restrict__ dcoef, const float* __restrict__ xhat,
                   const float* __restrict__ inv_std, const float* __restrict__ gamma, int B,
                   int H, int L, float* __restrict__ da1, float* __restrict__ g_gamma,
                   float* __restrict__ g_beta, float* __restrict__ g_b1) {
    const int k = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (k >= H) return;  // warp-uniform
    float sdh = 0.f, sdhx = 0.f;
    for (int r = lane; r < B; r += 32) {
        float dd = 0.f;
        for (int j = 0; j < L; ++j) {
            dd = fmaf(dmh[(size_t)r * L + j], wmu[(size_t)k * L + j], dd);
            dd = fmaf(dlh[(size_t)r * L + j], wlv[(size_t)k * L + j], dd);
        }
        const size_t i = (size_t)r * H + k;
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

// The noise NOISE_PHILOX draws at (seed, step): dropout keep flags
// (B, hidden) and eps (B, latent), for checking its statistics.
__global__ void noise_kernel(uint64_t seed, int step, int B, int H, int L, float* __restrict__ keep,
                             float* __restrict__ eps) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx < B * H) keep[idx] = philox_keep(seed, idx / H, idx % H, step);
    if (idx < B * L) eps[idx] = philox_normal(seed, idx / L, idx % L, step);
}

// torch-order AdamW over one flat buffer: decay first, then the
// bias-corrected Adam step.
__global__ void adamw_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                             const float* __restrict__ g, long long n, float lr, float wd,
                             float bc1, float bc2) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
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

#define CHECK(expr)                     \
    do {                                \
        const int _e = (int)(expr);     \
        if (_e != 0) return _e;         \
    } while (0)
#define LAUNCHED() CHECK(cudaGetLastError())

// One step: forward, loss, every gradient, new BN running stats.
int step_phases(const float* x, const float* t, const int64_t* site, const float* p,
                const Dims& d, int B, const float* rm_in, const float* rv_in, float* rm_out,
                float* rv_out, const float* eps_in, const float* drop_in, int noise,
                uint64_t seed, int step, float beta, float* loss, float* g, const Work& w,
                cudaStream_t st) {
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
    CHECK(gemm(Mat{x, X, 1}, Mat{P[W1], H, 1}, w.scratch, B, H, X, BIG, st, &sp));
    bn_forward_kernel<<<blocks(H, WARPS), THREADS, 0, st>>>(
        w.scratch, sp, B, H, P[B1], P[GAMMA], P[BNBETA], rm_in, rv_in, rm_out, rv_out, drop_in,
        noise, seed, step, w.xhat, w.dcoef, w.d, w.inv_std);
    LAUNCHED();
    const Heads heads = {P[WMU], P[BMU], P[WLV], P[BLV], P[EMB],
                         P[SMU_W], P[SMU_B], P[SLV_W], P[SLV_B]};
    posterior_kernel<<<blocks((size_t)B * L, WARPS), THREADS, 0, st>>>(w.d, site, heads, B, H, L, S, E, eps_in,
                                                         noise, seed, step, w.e, w.mu, w.lv,
                                                         w.epsv, w.sigma, w.z);
    LAUNCHED();
    CHECK(gemm(Mat{w.z, L, 1}, Mat{P[D1W], D1, 1}, w.scratch, B, D1, L, BIG, st, &sp));
    epilogue_kernel<<<blocks((size_t)B * D1), THREADS, 0, st>>>(w.scratch, sp, B, D1, P[D1B],
                                                                nullptr, w.r1, EPI_BIAS_RELU);
    LAUNCHED();
    CHECK(gemm(Mat{w.r1, D1, 1}, Mat{P[D2W], D2, 1}, w.scratch, B, D2, D1, BIG, st, &sp));
    epilogue_kernel<<<blocks((size_t)B * D2), THREADS, 0, st>>>(w.scratch, sp, B, D2, P[D2B],
                                                                nullptr, w.r2, EPI_BIAS_RELU);
    LAUNCHED();
    CHECK(gemm(Mat{w.r2, D2, 1}, Mat{P[D3W], O, 1}, w.scratch, B, O, D2, BIG, st, &sp));
    logits_kernel<<<LOSS_BLOCKS, THREADS, 0, st>>>(w.scratch, sp, B, O, P[D3B], t, w.dlogits,
                                                   w.part);
    LAUNCHED();
    loss_finish_kernel<<<1, THREADS, 0, st>>>(w.part, LOSS_BLOCKS, w.mu, w.lv, B * L, beta, loss);
    LAUNCHED();

    // ---- backward: decoder ----
    CHECK(gemm(Mat{w.r2, 1, D2}, Mat{w.dlogits, O, 1}, G[D3W], D2, O, B, 1, st, nullptr));
    colsum_kernel<<<blocks(O), THREADS, 0, st>>>(w.dlogits, B, O, G[D3B]);
    LAUNCHED();
    CHECK(gemm(Mat{w.dlogits, O, 1}, Mat{P[D3W], 1, O}, w.scratch, B, D2, O, BIG, st, &sp));
    epilogue_kernel<<<blocks((size_t)B * D2), THREADS, 0, st>>>(w.scratch, sp, B, D2, nullptr,
                                                                w.r2, w.du2, EPI_RELU_MASK);
    LAUNCHED();
    CHECK(gemm(Mat{w.r1, 1, D1}, Mat{w.du2, D2, 1}, G[D2W], D1, D2, B, 1, st, nullptr));
    colsum_kernel<<<blocks(D2), THREADS, 0, st>>>(w.du2, B, D2, G[D2B]);
    LAUNCHED();
    CHECK(gemm(Mat{w.du2, D2, 1}, Mat{P[D2W], 1, D2}, w.scratch, B, D1, D2, BIG, st, &sp));
    epilogue_kernel<<<blocks((size_t)B * D1), THREADS, 0, st>>>(w.scratch, sp, B, D1, nullptr,
                                                                w.r1, w.du1, EPI_RELU_MASK);
    LAUNCHED();
    CHECK(gemm(Mat{w.z, 1, L}, Mat{w.du1, D1, 1}, G[D1W], L, D1, B, 1, st, nullptr));
    colsum_kernel<<<blocks(D1), THREADS, 0, st>>>(w.du1, B, D1, G[D1B]);
    LAUNCHED();

    // ---- backward: posterior, heads, site embedding, encoder ----
    posterior_backward_kernel<<<blocks((size_t)B * L, WARPS), THREADS, 0, st>>>(
        w.du1, P[D1W], B, D1, L, w.mu, w.lv, w.epsv, w.sigma, beta, w.dmh, w.dlh);
    LAUNCHED();
    const HeadGrads hg = {G[WMU], G[BMU], G[WLV], G[BLV], G[SMU_W], G[SMU_B], G[SLV_W], G[SLV_B]};
    head_grads_kernel<<<blocks((size_t)2 * H * L + 2 * E * L + 2 * L), THREADS, 0, st>>>(
        w.d, w.e, w.dmh, w.dlh, B, H, E, L, hg);
    LAUNCHED();
    emb_grad_kernel<<<blocks((size_t)S * E), THREADS, 0, st>>>(site, w.dmh, w.dlh, P[SMU_W],
                                                               P[SLV_W], B, S, E, L, G[EMB]);
    LAUNCHED();
    bn_backward_kernel<<<blocks(H, WARPS), THREADS, 0, st>>>(w.dmh, w.dlh, P[WMU], P[WLV], w.dcoef,
                                                       w.xhat, w.inv_std, P[GAMMA], B, H, L,
                                                       w.da1, G[GAMMA], G[BNBETA], G[B1]);
    LAUNCHED();
    CHECK(gemm(Mat{x, 1, X}, Mat{w.da1, H, 1}, G[W1], X, H, B, 1, st, nullptr));
    return 0;
}

bool valid(const Dims& d, int B) {
    return B >= 1 && d.in > 0 && d.hid > 0 && d.latent > 0 && d.sites > 0 && d.embed > 0 &&
           d.d1 > 0 && d.d2 > 0 && d.out > 0;
}

Dims dims_from(const int* dims) {
    return Dims{dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], dims[7]};
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

// One train step. x (B, in), t (B, out), site (B,) int64; params: the flat
// parameter buffer; rm/rv in (hidden,) and out; eps_in (B, latent) and
// drop_in (B, hidden) when noise == 0 (NOISE_INJECTED), ignored when 1
// (NOISE_PHILOX, keyed by seed and step); loss (1,), grads: a flat buffer
// like params; work: rna2dna_train_workspace_floats(dims, B, 0) floats.
int rna2dna_train_step(const float* x, const float* t, const int64_t* site, const float* params,
                       const int* dims, int batch, const float* rm_in, const float* rv_in,
                       float* rm_out, float* rv_out, const float* eps_in, const float* drop_in,
                       int noise, unsigned long long seed, int step, float beta, float* loss,
                       float* grads, float* work, void* stream) {
    const Dims d = dims_from(dims);
    if (!valid(d, batch) || (noise == NOISE_INJECTED && (!eps_in || !drop_in)) ||
        (noise != NOISE_INJECTED && noise != NOISE_PHILOX)) {
        return (int)cudaErrorInvalidValue;
    }
    const Work w = plan(work, d, batch, false);
    return step_phases(x, t, site, params, d, batch, rm_in, rv_in, rm_out, rv_out, eps_in,
                       drop_in, noise, (uint64_t)seed, step, beta, loss, grads, w,
                       (cudaStream_t)stream);
}

// One epoch of n_batches steps on the rows x_ep (n_batches * B, in), t_ep,
// site_ep, eps_ep/drop_ep (injected mode), updating params, m, v (flat
// buffers) and rm/rv in place; losses (n_batches,). Step i draws its noise
// with step index i and applies AdamW with bias correction at step0 + i + 1.
int rna2dna_train_epoch(const float* x_ep, const float* t_ep, const int64_t* site_ep,
                        float* params, float* m, float* v, const int* dims, int batch,
                        int n_batches, float* rm, float* rv, const float* eps_ep,
                        const float* drop_ep, int noise, unsigned long long seed, float beta,
                        float lr, float wd, long long step0, float* losses, float* work,
                        void* stream) {
    const Dims d = dims_from(dims);
    if (!valid(d, batch) || n_batches < 1 ||
        (noise == NOISE_INJECTED && (!eps_ep || !drop_ep)) ||
        (noise != NOISE_INJECTED && noise != NOISE_PHILOX)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    const Work w = plan(work, d, batch, true);
    long long off[N_PARAMS];
    const long long n_params = param_offsets(d, off);
    for (int i = 0; i < n_batches; ++i) {
        const size_t r0 = (size_t)i * batch;
        CHECK(step_phases(x_ep + r0 * d.in, t_ep + r0 * d.out, site_ep + r0, params, d, batch, rm,
                          rv, rm, rv, noise == NOISE_INJECTED ? eps_ep + r0 * d.latent : nullptr,
                          noise == NOISE_INJECTED ? drop_ep + r0 * d.hid : nullptr, noise,
                          (uint64_t)seed, i, beta, losses + i, w.grads, w, st));
        const double t_step = (double)(step0 + i + 1);
        const float bc1 = (float)(1.0 - pow((double)ADAM_B1, t_step));
        const float bc2 = (float)(1.0 - pow((double)ADAM_B2, t_step));
        adamw_kernel<<<blocks((size_t)n_params), THREADS, 0, st>>>(params, m, v, w.grads,
                                                                    n_params, lr, wd, bc1, bc2);
        LAUNCHED();
    }
    return 0;
}

// The dropout mask (B, hidden) and eps (B, latent) that a step at (seed,
// step) draws in NOISE_PHILOX mode.
int rna2dna_train_noise(unsigned long long seed, int step, int batch, int hidden, int latent,
                        float* keep, float* eps, void* stream) {
    if (batch < 1 || hidden < 1 || latent < 1) return (int)cudaErrorInvalidValue;
    const size_t n = (size_t)batch * (hidden > latent ? hidden : latent);
    noise_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>((uint64_t)seed, step, batch,
                                                                  hidden, latent, keep, eps);
    return (int)cudaGetLastError();
}

const char* fused_train_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
