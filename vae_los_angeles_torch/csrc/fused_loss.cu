// RNA->DNA loss, BCE-with-logits sum + beta * KLD, and its closed-form
// backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of vae_los_angeles_tpu/ops/pallas/fused_loss.py:
//   * rna2dna_loss_forward  <- _loss_kernel / _loss_fwd_call
//   * rna2dna_loss_backward <- _grad_kernel / _loss_bwd_call
// joined, as jax.custom_vjp joins them there, by a torch.autograd.Function
// (ops/kernels/fused_loss.py):
//   loss      = sum(max(l, 0) - l * t + log1p(exp(-|l|))) + beta * KLD,
//   KLD       = -0.5 * sum(1 + logvar - mu^2 - exp(logvar)),
//   dlogits   = (sigmoid(l) - t) * g,  dmu = beta * mu * g,
//   dlogvar   = -beta / 2 * (1 - exp(logvar)) * g,  dbeta = KLD * g.
//
// What bounds it on an H100: the bytes. The forward reads logits and target
// once (8 bytes an element, a few flops and one expf + log1pf each); the
// backward reads both and writes dlogits (12 bytes an element). At the
// whole-methylome shapes that is 0.111 ms (forward, 103 x 450,000), 0.034 ms
// (forward, 32 x 450,000) and 0.052 ms (backward, 32 x 450,000) at 3.35
// TB/s, far below the card's balance point. At the cohort's shapes (B = 32
// or 205 rows of 1211) the inputs are a few hundred kB and the launch and
// its wrapper are the time.
//
// The design keeps enough bytes in flight and launches once:
//   * a persistent grid sized to the card: the SM count times the blocks an
//     SM holds at full occupancy (both queried once a device and cached),
//     fewer when n needs fewer; so the grid depends on (device, n) alone;
//   * each thread a grid-stride loop over float4 groups of every array, ILP
//     groups of each in flight (16-byte loads; 4 x 2 x 16 bytes a thread in
//     the forward), a scalar head up to the first 16-byte boundary and a
//     scalar tail for an n that is not a multiple of 4; arrays whose offsets
//     from a 16-byte boundary differ take a scalar grid-stride loop;
//   * the forward's sum: each thread's serial chain (~171-343 terms at 103 x
//     450,000, kept well under the ~1,024 beyond which an fp32 chain was seen
//     to drift), a warp-shuffle and block tree, one partial a block, and the
//     last block to finish (a __threadfence + atomicAdd ticket in the
//     workspace, which that block resets to 0) adds the partials in block
//     order and writes loss and KLD. No float atomics: the same inputs at the
//     same addresses give the same bits every run;
//   * the backward: the same loop, g and beta read once a thread, the latent
//     terms (dmu, dlogvar) by the first threads of the same launch;
//   * a thread's first latent pair is read before its first logits, so that
//     at small n, where a thread has one float4 group, the two reads of the
//     thread overlap instead of following each other.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_probes.py loss, calls back
// to back between CUDA events; PERF.md section 6 rows 5-6): the forward at
// 88% of its byte bound at 103 x 450,000 (0.1251 ms) and 75% at 32 x 450,000
// (0.0457 ms), the backward at 82% at 32 x 450,000 (0.0632 ms), where the
// first design (a fixed grid of 64 blocks and a second launch to finish the
// forward; one thread an element in the backward) took 0.7830, 0.2460 and
// 0.0808 ms. The rest is not profiled (the card's
// machine runs no ncu); the candidates are the grid's ramp-up and drain and,
// in the forward, each element's expf + log1pf.
//
// Plain C interface, built with nvcc and called through ctypes; each entry
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ILP = 4;  // float4 groups of each array in flight per thread
constexpr int MAX_DEVICES = 64;
constexpr int TICKET_FLOATS = 4;  // the ticket, padded to 16 bytes
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bce(float l, float t) {
    return fmaxf(l, 0.f) - l * t + log1pf(expf(-fabsf(l)));
}

__device__ __forceinline__ float bce4(float4 l, float4 t) {
    return ((bce(l.x, t.x) + bce(l.y, t.y)) + bce(l.z, t.z)) + bce(l.w, t.w);
}

__device__ __forceinline__ float dlogit(float l, float t, float g) {
    return (1.0f / (1.0f + expf(-l)) - t) * g;
}

__device__ __forceinline__ float4 dlogit4(float4 l, float4 t, float g) {
    return make_float4(dlogit(l.x, t.x, g), dlogit(l.y, t.y, g), dlogit(l.z, t.z, g),
                       dlogit(l.w, t.w, g));
}

// Sums a and c over the block in a fixed tree (warp shuffles, then warp 0
// over the warps' sums); the sums are valid in thread 0. Every thread calls it.
__device__ __forceinline__ void block_sum2(float& a, float& c, float (*red)[WARPS]) {
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(FULL, a, o);
        c += __shfl_xor_sync(FULL, c, o);
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
        red[0][warp] = a;
        red[1][warp] = c;
    }
    __syncthreads();
    if (warp == 0) {
        a = lane < WARPS ? red[0][lane] : 0.f;
        c = lane < WARPS ? red[1][lane] : 0.f;
        for (int o = WARPS / 2; o > 0; o >>= 1) {
            a += __shfl_xor_sync(FULL, a, o);
            c += __shfl_xor_sync(FULL, c, o);
        }
    }
}

// head >= 0: logits and t share their offset from a 16-byte boundary, and
// elements [0, head) come before the first float4 group; head < 0: scalar.
// work: the ticket (TICKET_FLOATS), then gridDim.x BCE and gridDim.x KLD
// partials. out[0] = loss, out[1] = KLD (kept for dbeta).
__global__ void __launch_bounds__(THREADS)
loss_forward_kernel(const float* __restrict__ logits, const float* __restrict__ t, long long n,
                    int head, const float* __restrict__ mu, const float* __restrict__ lv,
                    long long nl, const float* __restrict__ beta, float* __restrict__ out,
                    float* __restrict__ work) {
    __shared__ float red[2][WARPS];
    __shared__ bool last;
    const long long stride = (long long)gridDim.x * THREADS;
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    float b = 0.f, k = 0.f;
    // the thread's first latent pair is read before the logits, so that both
    // reads are in flight together (at small n a thread has one of each)
    float m0 = 0.f, v0 = 0.f;
    if (tid < nl) {
        m0 = mu[tid];
        v0 = lv[tid];
    }
    if (head >= 0) {
        if (tid < head) b = bce(logits[tid], t[tid]);
        const float4* l4 = reinterpret_cast<const float4*>(logits + head);
        const float4* t4 = reinterpret_cast<const float4*>(t + head);
        const long long n4 = (n - head) >> 2;
        long long i = tid;
        for (; i + (ILP - 1) * stride < n4; i += ILP * stride) {
            float4 a[ILP], c[ILP];
#pragma unroll
            for (int u = 0; u < ILP; ++u) {
                a[u] = l4[i + u * stride];
                c[u] = t4[i + u * stride];
            }
#pragma unroll
            for (int u = 0; u < ILP; ++u) b += bce4(a[u], c[u]);
        }
        for (; i < n4; i += stride) b += bce4(l4[i], t4[i]);
        const long long r = head + 4 * n4 + tid;  // the tail: at most 3 elements
        if (r < n) b += bce(logits[r], t[r]);
    } else {
        for (long long i = tid; i < n; i += stride) b += bce(logits[i], t[i]);
    }
    if (tid < nl) k = 1.0f + v0 - m0 * m0 - expf(v0);
    for (long long i = tid + stride; i < nl; i += stride) {
        const float m = mu[i], v = lv[i];
        k += 1.0f + v - m * m - expf(v);
    }
    block_sum2(b, k, red);

    unsigned* ticket = reinterpret_cast<unsigned*>(work);
    float* part = work + TICKET_FLOATS;
    const int blocks = gridDim.x;
    if (threadIdx.x == 0) {
        part[blockIdx.x] = b;
        part[blocks + blockIdx.x] = k;
        __threadfence();  // the partials are visible before the ticket is taken
        last = atomicAdd(ticket, 1u) == (unsigned)(blocks - 1);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    b = 0.f;
    k = 0.f;
    for (int i = threadIdx.x; i < blocks; i += THREADS) {
        b += __ldcg(part + i);
        k += __ldcg(part + blocks + i);
    }
    block_sum2(b, k, red);
    if (threadIdx.x == 0) {
        const float kld = -0.5f * k;
        out[0] = b + beta[0] * kld;
        out[1] = kld;
        *ticket = 0u;  // ready for the next launch on this workspace
    }
}

// head as in the forward, for logits, t and dlogits together.
__global__ void __launch_bounds__(THREADS)
loss_backward_kernel(const float* __restrict__ logits, const float* __restrict__ t, long long n,
                     int head, const float* __restrict__ mu, const float* __restrict__ lv,
                     long long nl, const float* __restrict__ beta, const float* __restrict__ g,
                     float* __restrict__ dlogits, float* __restrict__ dmu,
                     float* __restrict__ dlv) {
    const long long stride = (long long)gridDim.x * THREADS;
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    const float gv = g[0], bv = beta[0];
    // the thread's first latent pair: read here, written after the logits'
    // part, so that both reads are in flight together
    float m0 = 0.f, v0 = 0.f;
    if (tid < nl) {
        m0 = mu[tid];
        v0 = lv[tid];
    }
    if (head >= 0) {
        if (tid < head) dlogits[tid] = dlogit(logits[tid], t[tid], gv);
        const float4* l4 = reinterpret_cast<const float4*>(logits + head);
        const float4* t4 = reinterpret_cast<const float4*>(t + head);
        float4* d4 = reinterpret_cast<float4*>(dlogits + head);
        const long long n4 = (n - head) >> 2;
        long long i = tid;
        for (; i + (ILP - 1) * stride < n4; i += ILP * stride) {
            float4 a[ILP], c[ILP];
#pragma unroll
            for (int u = 0; u < ILP; ++u) {
                a[u] = l4[i + u * stride];
                c[u] = t4[i + u * stride];
            }
#pragma unroll
            for (int u = 0; u < ILP; ++u) d4[i + u * stride] = dlogit4(a[u], c[u], gv);
        }
        for (; i < n4; i += stride) d4[i] = dlogit4(l4[i], t4[i], gv);
        const long long r = head + 4 * n4 + tid;
        if (r < n) dlogits[r] = dlogit(logits[r], t[r], gv);
    } else {
        for (long long i = tid; i < n; i += stride) dlogits[i] = dlogit(logits[i], t[i], gv);
    }
    if (tid < nl) {
        dmu[tid] = bv * m0 * gv;
        dlv[tid] = -0.5f * bv * (1.0f - expf(v0)) * gv;
    }
    for (long long i = tid + stride; i < nl; i += stride) {
        dmu[i] = bv * mu[i] * gv;
        dlv[i] = -0.5f * bv * (1.0f - expf(lv[i])) * gv;
    }
}

// The grid of a kernel on the current device at full occupancy (SMs x blocks
// an SM holds), queried once a device and kept in `cache`.
cudaError_t full_grid(const void* kernel, int* cache, int* grid) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && cache[dev] > 0) {
        *grid = cache[dev];
        return cudaSuccess;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    *grid = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < MAX_DEVICES) cache[dev] = *grid;
    return cudaSuccess;
}

int forward_grids[MAX_DEVICES];
int backward_grids[MAX_DEVICES];

// Blocks for n elements: at least one float4 group a thread, at most the
// full grid.
int grid_for(long long n, int full) {
    const long long want = (n + 4LL * THREADS - 1) / (4LL * THREADS);
    return want < 1 ? 1 : (want < full ? (int)want : full);
}

// The scalar head before the first 16-byte boundary when every array shares
// that boundary's offset, else -1 (the scalar route).
int vector_head(long long n, const void* a, const void* b, const void* c) {
    const uintptr_t pa = (uintptr_t)a;
    if ((pa & 3) || ((pa ^ (uintptr_t)b) & 15) || (c && ((pa ^ (uintptr_t)c) & 15))) return -1;
    const long long head = (long long)((16 - (pa & 15)) & 15) / 4;
    return (int)(head < n ? head : n);
}

}  // namespace

extern "C" {

// Floats of device workspace the forward needs on the current device; the
// caller zeroes it once, and every launch leaves its ticket at 0 again. A
// value <= 0 is minus a CUDA error.
int rna2dna_loss_workspace_floats() {
    int full = 0;
    const cudaError_t err =
        full_grid((const void*)loss_forward_kernel, forward_grids, &full);
    if (err != cudaSuccess) return -(int)err;
    return TICKET_FLOATS + 2 * full;
}

// logits, t: n floats; mu, logvar: nl floats; beta: 1 float on the device;
// out: 2 floats (loss, KLD); work: rna2dna_loss_workspace_floats() floats,
// used by one stream at a time. One launch.
int rna2dna_loss_forward(const float* logits, const float* t, long long n, const float* mu,
                         const float* lv, long long nl, const float* beta, float* out,
                         float* work, void* stream) {
    if (n < 0 || nl < 0) return (int)cudaErrorInvalidValue;
    int full = 0;
    const cudaError_t err =
        full_grid((const void*)loss_forward_kernel, forward_grids, &full);
    if (err != cudaSuccess) return (int)err;
    loss_forward_kernel<<<grid_for(n, full), THREADS, 0, (cudaStream_t)stream>>>(
        logits, t, n, vector_head(n, logits, t, nullptr), mu, lv, nl, beta, out, work);
    return (int)cudaGetLastError();
}

// The closed-form backward; g: the upstream gradient, 1 float on the device.
// One launch.
int rna2dna_loss_backward(const float* logits, const float* t, long long n, const float* mu,
                          const float* lv, long long nl, const float* beta, const float* g,
                          float* dlogits, float* dmu, float* dlv, void* stream) {
    if (n < 0 || nl < 0) return (int)cudaErrorInvalidValue;
    if (n == 0 && nl == 0) return 0;
    int full = 0;
    const cudaError_t err =
        full_grid((const void*)loss_backward_kernel, backward_grids, &full);
    if (err != cudaSuccess) return (int)err;
    loss_backward_kernel<<<grid_for(n > nl ? n : nl, full), THREADS, 0, (cudaStream_t)stream>>>(
        logits, t, n, vector_head(n, logits, t, dlogits), mu, lv, nl, beta, g, dlogits, dmu,
        dlv);
    return (int)cudaGetLastError();
}

const char* fused_loss_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
