// Fused eval forwards of the directional VAEs, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of vae_los_angeles_tpu/ops/pallas/fused_vae.py:
//   * rna2dna_fused_forward  <- _make_rna2dna_kernel / _rna2dna_call (FusedRNA2DNA)
//   * dna2rna_fused_forward  <- _make_dna2rna_kernel / _dna2rna_call (FusedDNA2RNA)
// Each computes, for a batch of rows, the whole eval forward: encoder
// Linear(s) with eval BatchNorm folded in (host side, once, by
// ops/nn.fold_bn_eval) and ReLU; the mu/logvar heads; the site term as a
// row gather of the embedding table (the TPU's one-hot matmul: an index out
// of [0, n_sites) gives a zero row, as one_hot does) with its heads and the
// arithmetic-mean fusion; z = mu + eps * exp(logvar / 2); the decoder chain,
// with a sigmoid epilogue for RNA->DNA and a linear head for DNA->RNA.
//
// Noise modes: NOISE_NONE gives z = mu; NOISE_EPS reads an injected (B, L)
// eps; NOISE_PHILOX draws eps by Box-Muller on (0, 1] uniforms from
// Philox4x32-10 keyed by the 64-bit seed, with the counter (global row,
// latent index, 0, 0), the global row being the call's row0 plus the row
// within the call (a rank serving rows [row0, row0 + batch) of a sharded
// cohort draws what the whole cohort's call draws for them), so a row's
// noise does not depend on the batch it is served in nor on the tiling (ops/kernels/fused_vae.philox_normal_reference
// is the same draw in plain PyTorch).
//
// What bounds it on an H100: ~0.9 MFLOP a row against ~3.7 MB of weights at
// the cohort's widths, so at a few hundred rows the call is bound by how
// fast the weights reach the SMs and by the latency of eight dependent
// products, not by FLOPs; at the whole-methylome width (DecoderB 512 x
// 450,000, 0.92 GB) or a wide DNA input (65,536 x 512) one layer's weight is
// most of the bytes and most of the FLOPs. The design:
//   * The narrow trunk (everything but a wide first or last layer) runs on
//     thread block clusters (trunk_kernel). A cluster owns a tile of `rows`
//     rows; each of its C CTAs computes a column slab (1/C of the quads of
//     four columns) of every product for all of the tile's rows and writes
//     it into every CTA's copy of the activation through distributed shared
//     memory, then cluster.sync() before the next layer reads it. So an SM
//     reads 1/C of the weights, where the first design streamed them all
//     through each SM. Each activation has its own buffer (no buffer is
//     written twice in a call), so the only barriers between layers are the
//     cluster's, one a layer.
//   * A CTA's weight slabs reach it as one stream of chunks through a ring
//     of shared-memory slots, SLOTS - 1 chunks in flight: TMA bulk copies
//     completing on the slot's mbarrier, one a chunk, since the weights are
//     stored slab-major (each CTA's columns contiguous, fused_vae.py
//     _slab_major): an SM pulls contiguous chunks from L2 faster than row
//     segments. The first layer's input rows, which need not be 16-byte
//     aligned, come by cp.async of single floats beside them. Weights do not
//     depend on activations, so the next layer's weights arrive while this
//     layer computes and while the cluster syncs, and the first layer takes
//     any input width. Each CTA's piece table (which columns, chunk sizes and
//     slices each product takes) is built once per plan on the host.
//   * A wide layer (SWEEP_MIN_IN inputs or SWEEP_MIN_OUT outputs wide, in
//     ops/kernels/fused_vae.py, chosen on the card) leaves the trunk for a
//     whole-grid sweep (sweep_kernel) that reads its weight once a call: a
//     CTA owns 128 output columns, a split of K and up to 128 rows, stages
//     the rows and the weight tile in chunks of 32 inputs (cp.async, two
//     buffers) and keeps 16 rows x 4 columns of sums a thread. A wide output layer reads the trunk's last hidden
//     activation from scratch; a wide first layer writes per-split partial
//     sums that the trunk adds in split order.
//   * Every product is fp32 FMA (no TF32, no tensor cores yet). A trunk
//     thread owns 4 rows x 4 columns for an input slice; the lanes of a warp
//     run over column quads (broadcast activation reads, consecutive weight
//     reads); the slices are added in slice order through shared memory;
//     every sum runs in a fixed order, with no atomics, so two calls give
//     the same bits.
//
// Plain C interface, built with nvcc into a shared library and called through
// ctypes (vae_los_angeles_torch/ops/kernels/_build.py, fused_vae.py). The
// Python side builds the Model (weight pointers and widths) once per wrapper
// and the Plan (tiling and sweep splits) once per batch bucket (a power of
// two); a call passes its batch, from which the grids follow, launches one
// to three kernels on the caller's stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TRUNK_THREADS = 512;  // 16 warps a CTA
constexpr int SWEEP_THREADS = 256;  // 8 warps: two sweep CTAs an SM
constexpr int MAX_SMEM = 232448;    // per-block opt-in maximum on sm_90
constexpr int CLUSTER = 8;          // CTAs of a trunk cluster (the portable maximum)
constexpr int TR = 4;               // rows of a trunk thread's register tile
constexpr int SW_COLS = 128;        // a sweep CTA's output columns (32 lanes x 4)
constexpr int SW_KC = 32;           // input columns a sweep chunk stages
constexpr int SW_ROWS = 128;        // a sweep CTA's rows
constexpr int SW_WARPS = SWEEP_THREADS / 32;
constexpr int SW_RPW = SW_ROWS / SW_WARPS;  // rows of a sweep warp
constexpr int SWEEP_SMEM = 4 * 2 * (SW_ROWS * SW_KC + SW_KC * SW_COLS);

enum NoiseMode { NOISE_NONE = 0, NOISE_PHILOX = 1, NOISE_EPS = 2 };
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2 };

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

}  // namespace

extern "C" {

// The model, built once per wrapper (fused_vae._Model mirrors it field for
// field). Weights are device pointers to zero-padded copies: a (K, N) matrix
// is (pad4(K), pad4(N)) row-major, a bias pad4(N). The heads are packed as
// [mu | logvar] along the columns, each half pad4(latent) wide: wh
// (pad4(enc out), 2 Lp), ws (pad4(embed), 2 Lp). RNA->DNA: one encoder
// layer, decoder latent -> d1 -> d2 -> out; DNA->RNA: two encoder layers,
// decoder latent -> d1 -> out.
struct Model {
    const float* ew[2];
    const float* eb[2];
    const float* wh;
    const float* bh;
    const float* emb;
    const float* ws;
    const float* bs;
    const float* dw[3];
    const float* db[3];
    int in;
    int en[2];
    int n_enc;
    int latent, sites, embed;
    int dn[3];
    int n_dec;
    int out_act;
};

// One batch bucket's tiling, for calls of up to `batch` rows
// (fused_vae.serving_plan computes it; _Plan mirrors it). The trunk: a
// cluster of CLUSTER CTAs a tile of `rows` rows, `trunk_smem` bytes a CTA, of
// which the weight ring's slots take `slot_f` floats each. The input sweep
// (in_sweep): in_slabs slabs of columns, K split every in_kps columns into
// in_splits. The output sweep (out_sweep): out_slabs slabs. A call of n rows
// launches ceil(n / rows) clusters and ceil(n / SW_ROWS) sweep row blocks.
struct Plan {
    int batch, rows, trunk_smem, slot_f;
    int in_sweep, in_slabs, in_splits, in_kps;
    int out_sweep, out_slabs;
};

}  // extern "C"

namespace {

__device__ __forceinline__ float activate(float v, int act) {
    if (act == ACT_RELU) return fmaxf(v, 0.0f);
    if (act == ACT_SIGMOID) return 1.0f / (1.0f + expf(-v));
    return v;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& w) {
    acc[0] = fmaf(a, w.x, acc[0]);
    acc[1] = fmaf(a, w.y, acc[1]);
    acc[2] = fmaf(a, w.z, acc[2]);
    acc[3] = fmaf(a, w.w, acc[3]);
}

// cp.async of one float (zeros where !valid) and of 16 bytes (zeros where
// !valid); groups committed and waited for as in fused_wide.cu.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_two() {  // all but the newest two groups
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// Philox4x32-10 (Salmon et al., SC'11), the counter-based generator of
// Random123 and cuRAND.
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

// Standard normal for (global row, j): Box-Muller on two (0, 1] uniforms
// built from the top 24 bits of two Philox words (as fused_vae.py:77-92 does
// with the TPU PRNG's bits).
__device__ __forceinline__ float philox_normal(uint64_t seed, int row, int j) {
    const uint4 bits = philox4x32_10(make_uint4((uint32_t)row, (uint32_t)j, 0u, 0u),
                                     make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)));
    const float u1 = (float)((bits.x >> 8) + 1u) * (1.0f / 16777216.0f);
    const float u2 = (float)((bits.y >> 8) + 1u) * (1.0f / 16777216.0f);
    return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

// z = mu + eps * exp(logvar / 2), the same instruction for drawn and
// injected eps, so equal eps give equal bits.
__device__ __forceinline__ float reparameterize(float m, float v, float e) {
    return fmaf(e, expf(0.5f * v), m);
}

// ---------------------------------------------------------------------------
// the trunk

// A trunk CTA computes each product in pieces: a piece is a run of at most
// piece_quads() of the CTA's column quads. Its weight tile streams through
// a ring of SLOTS shared-memory slots in chunks of kw inputs (TMA bulk
// copies completing on the slot's mbarrier: one a chunk where the piece is
// its CTA's whole slab, else one a weight row), SLOTS - 1 chunks in flight; the first layer's chunks also carry the input rows'
// tile (cp.async of single floats: input rows need not be 16-byte aligned),
// and a piece's last chunk its bias. The chunks of all the call's pieces
// form one stream: weights do not depend on activations, so the next
// layer's chunks are in flight while this one computes and while the
// cluster syncs. The piece tables are built once per plan on the host
// (fused_vae_tables) and copied into shared memory at the kernel's start.
constexpr int SLOTS = 4;
constexpr int MAX_SLICES = 8;
constexpr int RED_FLOATS = 16 * TRUNK_THREADS;  // the slices' partial sums of a piece
constexpr int MAX_PIECES = 24;
constexpr int PIECE_FLOATS = 1024;  // the piece table, then the slots' mbarriers
enum Phase { PH_L0, PH_L1, PH_HEADS, PH_D0, PH_D1, PH_OUT, N_PHASES };
enum GlobalDest { G_NONE = 0, G_RECON = 1, G_HID = 2 };

// One piece, position-independent: shared-memory buffers are offsets in
// floats into the CTA's dynamic shared memory; global outputs are rows
// row0 + r of recon or hid.
struct Piece {
    const float* W;  // the piece's first column of its CTA's slab-major block (row stride wld)
    const float* bias;
    int in_off;  // the input activations (row stride in_ld); -1: the input rows, staged
    int in_ld, K, wld, act;
    int qa, qp;  // the piece's first (global) quad and its quads
    int kw, chunks, S;  // inputs a chunk, chunks, input slices (a power of two)
    int d_off, d_ld;  // this CTA's output buffer, written into every CTA; -1: none
    int g_dst, g_ld, g_cols;  // global output (GlobalDest), row stride, columns stored
};

struct PieceTable {
    Piece pc[MAX_PIECES];
    int ends[N_PHASES];  // ends[ph]: one past the phase's last piece
    int n;
};
static_assert(sizeof(PieceTable) + SLOTS * 8 <= 4 * PIECE_FLOATS, "piece table too large");
static_assert(sizeof(PieceTable) % 4 == 0, "piece table copied as words");

// Shared-memory plan of a trunk CTA, in floats (mirrored by
// fused_vae._trunk_floats): the piece table and the mbarriers, the ring,
// the slices' partial sums, then one buffer per activation, rb = pad4(rows)
// rows each: the encoder layers, the heads [mu | logvar] and the site heads
// (2 Lp each), the embedding rows, z, the decoder's hidden layers. Every
// offset is a multiple of four floats.
struct TrunkSmem {
    int pieces, ring, red, a[2], hd, sd, es, z, d[2], total;
};

__host__ __device__ inline TrunkSmem trunk_smem(const Model& m, int rows, int slot_f) {
    const int rb = pad4(rows), Lp = pad4(m.latent);
    TrunkSmem s;
    s.pieces = 0;
    s.ring = PIECE_FLOATS;
    s.red = s.ring + SLOTS * slot_f;
    s.a[0] = s.red + RED_FLOATS;
    s.a[1] = s.a[0] + rb * pad4(m.en[0]);
    s.hd = s.a[1] + (m.n_enc > 1 ? rb * pad4(m.en[1]) : 0);
    s.sd = s.hd + rb * 2 * Lp;
    s.es = s.sd + rb * 2 * Lp;
    s.z = s.es + rb * pad4(m.embed);
    s.d[0] = s.z + rb * Lp;
    s.d[1] = s.d[0] + rb * pad4(m.dn[0]);
    s.total = s.d[1] + (m.n_dec > 2 ? rb * pad4(m.dn[1]) : 0);
    return s;
}

// This CTA's quads [q0, q1) of the pad4(n) / 4 column quads.
__host__ __device__ inline void quad_range(int n, int rank, int size, int& q0, int& q1) {
    const int Q = pad4(n) / 4;
    q0 = rank * Q / size;
    q1 = (rank + 1) * Q / size;
}

// Quads a piece may take: one item (row group, quad) a thread, and a slot
// that holds a weight tile of four inputs, the input rows' tile of four
// inputs where they are staged, and the bias.
inline int piece_quads(int rb, int slot_f, bool rows_staged) {
    const int by_threads = TRUNK_THREADS / (rb / TR);
    const int by_slot = (slot_f - (rows_staged ? 4 * rb : 0)) / 20;
    return by_threads < by_slot ? by_threads : by_slot;
}

// The pieces of one product on a CTA's slab, appended to t. W is
// slab-major: rank r's columns [4 q0, 4 q1) form one contiguous (pad4(K),
// 4 (q1 - q0)) block, the blocks in rank order (fused_vae._slab_major), so
// a piece that takes its CTA's whole slab reads each chunk as one block.
void add_pieces(PieceTable& t, const float* W, const float* bias, int K, int N, int act,
                int in_off, int in_ld, int d_off, int d_ld, int g_dst, int g_ld, int g_cols,
                int rank, int size, int rb, int slot_f) {
    int q0, q1;
    quad_range(N, rank, size, q0, q1);
    const int G = rb / TR, Kp = pad4(K), xr = in_off < 0 ? rb : 0;
    const int qmax = piece_quads(rb, slot_f, in_off < 0);
    for (int qa = q0; qa < q1; qa += qmax) {
        if (t.n == MAX_PIECES) {
            t.n = MAX_PIECES + 1;  // refused by the caller
            return;
        }
        Piece& p = t.pc[t.n++];
        p.W = W + (size_t)Kp * 4 * q0 + 4 * (qa - q0);
        p.bias = bias;
        p.in_off = in_off;
        p.in_ld = in_ld;
        p.K = K;
        p.wld = 4 * (q1 - q0);
        p.act = act;
        p.qa = qa;
        p.qp = q1 - qa < qmax ? q1 - qa : qmax;
        const int kw = ((slot_f - 4 * p.qp) / (4 * p.qp + xr)) & ~3;
        p.kw = kw < 4 ? 4 : (kw > Kp ? Kp : kw);
        p.chunks = (Kp + p.kw - 1) / p.kw;
        int S = 1;
        while (S < MAX_SLICES && 2 * S * G * p.qp <= TRUNK_THREADS && 2 * S <= p.kw / 4) S *= 2;
        p.S = S;
        p.d_off = d_off;
        p.d_ld = d_ld;
        p.g_dst = g_dst;
        p.g_ld = g_ld;
        p.g_cols = g_cols;
    }
}

// The piece table of CTA `rank` of a cluster (file note), by phase.
void build_pieces(const Model& m, const Plan& p, bool has_site, int rank, PieceTable& t) {
    const TrunkSmem L = trunk_smem(m, p.rows, p.slot_f);
    const int rb = pad4(p.rows), Lp = pad4(m.latent), sf = p.slot_f, C = CLUSTER;
    t.n = 0;
    if (!p.in_sweep)
        add_pieces(t, m.ew[0], m.eb[0], m.in, m.en[0], ACT_RELU, -1, 0, L.a[0], pad4(m.en[0]),
                   G_NONE, 0, 0, rank, C, rb, sf);
    t.ends[PH_L0] = t.n;
    if (m.n_enc > 1)
        add_pieces(t, m.ew[1], m.eb[1], m.en[0], m.en[1], ACT_RELU, L.a[0], pad4(m.en[0]), L.a[1],
                   pad4(m.en[1]), G_NONE, 0, 0, rank, C, rb, sf);
    t.ends[PH_L1] = t.n;
    const int he = m.en[m.n_enc - 1];
    add_pieces(t, m.wh, m.bh, he, 2 * Lp, ACT_NONE, L.a[m.n_enc - 1], pad4(he), L.hd, 2 * Lp,
               G_NONE, 0, 0, rank, C, rb, sf);
    if (has_site)
        add_pieces(t, m.ws, m.bs, m.embed, 2 * Lp, ACT_NONE, L.es, pad4(m.embed), L.sd, 2 * Lp,
                   G_NONE, 0, 0, rank, C, rb, sf);
    t.ends[PH_HEADS] = t.n;
    int in = L.z, kw = m.latent, ld = Lp;
    for (int l = 0; l + 1 < m.n_dec; ++l) {
        const int np = pad4(m.dn[l]);
        if (p.out_sweep && l + 2 == m.n_dec)  // the last hidden layer feeds the output sweep
            add_pieces(t, m.dw[l], m.db[l], kw, m.dn[l], ACT_RELU, in, ld, -1, 0, G_HID, np, np,
                       rank, C, rb, sf);
        else
            add_pieces(t, m.dw[l], m.db[l], kw, m.dn[l], ACT_RELU, in, ld, L.d[l], np, G_NONE, 0,
                       0, rank, C, rb, sf);
        t.ends[PH_D0 + l] = t.n;
        in = L.d[l];
        kw = m.dn[l];
        ld = np;
    }
    if (m.n_dec < 3) t.ends[PH_D1] = t.n;
    if (!p.out_sweep) {
        const int l = m.n_dec - 1, out = m.dn[l];
        add_pieces(t, m.dw[l], m.db[l], kw, out, m.out_act, in, ld, -1, 0, G_RECON, out, out,
                   rank, C, rb, sf);
    }
    t.ends[PH_OUT] = t.n;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done = 0;
    do {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// The stream: its pieces and the issue cursor (the next chunk to copy,
// piece p, chunk j, and the index c of the next commit group / chunk).
struct Stream {
    const Piece* pc;
    int n;
    float* sm;
    float* ring;
    uint64_t* bars;
    int slot_f;
    const float* x;  // the input rows
    int in, row0, rows_valid, rb;
    float* recon;
    float* hid;
    int p, j, c;
};

// Copy the cursor's chunk into its slot: the weight tile (kr rows of qp
// quads, row stride 4 qp) by TMA on the slot's mbarrier, one copy where the
// piece takes its CTA's whole slab, else one a row; for the first
// layer the input rows' tile (rb x kr, row stride kw; zeros past the valid
// rows and past `in`) by cp.async; with the piece's last chunk its bias.
// Commits one cp.async group (an empty one past the last chunk, so every
// wait counts the same).
__device__ void issue(Stream& st) {
    if (st.p < st.n) {
        const Piece& P = st.pc[st.p];
        const int slot = st.c % SLOTS;
        float* s = st.ring + slot * st.slot_f;
        uint64_t* bar = st.bars + slot;
        const int k0 = st.j * P.kw, kr = min(P.kw, pad4(P.K) - k0);
        const bool last = st.j + 1 == P.chunks;
        const int xr = P.in_off < 0 ? st.rb : 0;
        if (threadIdx.x == 0)
            mbar_expect(bar, 16u * P.qp * (kr + (last ? 1 : 0)));
        if (4 * P.qp == P.wld) {
            if (threadIdx.x == 0) bulk_copy(s, P.W + (size_t)k0 * P.wld, 16u * P.qp * kr, bar);
        } else {
            for (int k = threadIdx.x; k < kr; k += blockDim.x)
                bulk_copy(s + k * 4 * P.qp, P.W + (size_t)(k0 + k) * P.wld, 16u * P.qp, bar);
        }
        if (last && threadIdx.x == blockDim.x - 1)
            bulk_copy(s + P.kw * (4 * P.qp + xr), P.bias + 4 * P.qa, 16u * P.qp, bar);
        if (xr) {
            float* xs = s + P.kw * 4 * P.qp;
            for (int e = threadIdx.x; e < st.rb * kr; e += blockDim.x) {
                const int r = e / kr, k = e - r * kr;
                const bool ok = r < st.rows_valid && k0 + k < st.in;
                cp_async4(xs + r * P.kw + k,
                          ok ? st.x + (size_t)(st.row0 + r) * st.in + k0 + k : st.x, ok);
            }
        }
        if (last) {
            st.j = 0;
            ++st.p;
        } else {
            ++st.j;
        }
    }
    cp_async_commit();
    ++st.c;
}

// act(v + b) of row r, quad q where the piece says.
__device__ __forceinline__ void store_quad(const Piece& P, const Stream& st, int r, int q, float4 v,
                                           float4 b, cg::cluster_group& cluster) {
    v = make_float4(activate(v.x + b.x, P.act), activate(v.y + b.y, P.act),
                    activate(v.z + b.z, P.act), activate(v.w + b.w, P.act));
    if (P.d_off >= 0) {
        const int n = (int)cluster.num_blocks();
        for (int k = 0; k < n; ++k) {
            float* dst = cluster.map_shared_rank(st.sm + P.d_off, k);
            *reinterpret_cast<float4*>(dst + r * P.d_ld + 4 * q) = v;
        }
    }
    if (P.g_dst != G_NONE && r < st.rows_valid) {
        float* g = (P.g_dst == G_RECON ? st.recon : st.hid) + (size_t)(st.row0 + r) * P.g_ld;
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            if (4 * q + c < P.g_cols) g[4 * q + c] = vv[c];
        }
    }
}

// Pieces [pa, pb) of the stream: for each chunk, wait for it (its TMA
// bytes on the slot's mbarrier, this thread's cp.async group), sync the
// block (every thread's copies are in, and every thread is done with the
// slot the next issue overwrites), issue the chunk SLOTS - 1 ahead, and add
// the chunk's products: thread (slice s, row group g, quad ql) holds TR rows
// x 4 columns of sums over inputs 4 s, 4 (s + S), ... of the chunk; lanes
// run over quads, so a warp's activation reads are broadcasts and its weight
// reads consecutive. Then the S slices are added in slice order through
// `red` (or stored directly when S = 1), with the bias from the last slot.
__device__ void run_pieces(int pa, int pb, int& cc, Stream& st, float* red,
                           cg::cluster_group& cluster) {
    const int G = st.rb / TR;
    for (int pi = pa; pi < pb; ++pi) {
        const Piece& P = st.pc[pi];
        const int gq = G * P.qp, total = P.S * gq;
        const int item = threadIdx.x;
        const bool live = item < total;
        const int s = item / gq, g = (item % gq) / P.qp, ql = item % P.qp;
        const int wld = 4 * P.qp, xr = P.in_off < 0 ? st.rb : 0;
        float acc[TR][4];
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
        const float* slot = st.ring;
        for (int j = 0; j < P.chunks; ++j, ++cc) {
            mbar_wait(st.bars + cc % SLOTS, (cc / SLOTS) & 1);
            cp_async_wait_two();  // SLOTS - 2 newer groups may still be in flight
            __syncthreads();
            issue(st);
            slot = st.ring + (cc % SLOTS) * st.slot_f;
            if (!live) continue;
            const int k0 = j * P.kw, kq_n = min(P.kw, pad4(P.K) - k0) / 4;
            const float* ws = slot + 4 * ql;
            const float* as;
            int ald;
            if (xr) {
                as = slot + P.kw * wld;
                ald = P.kw;
            } else {
                as = st.sm + P.in_off + k0;
                ald = P.in_ld;
            }
            as += g * TR * ald;
            for (int kq = s; kq < kq_n; kq += P.S) {
                float4 a[TR];
#pragma unroll
                for (int i = 0; i < TR; ++i)
                    a[i] = *reinterpret_cast<const float4*>(as + i * ald + 4 * kq);
                const float4 w0 = *reinterpret_cast<const float4*>(ws + (4 * kq + 0) * wld);
                const float4 w1 = *reinterpret_cast<const float4*>(ws + (4 * kq + 1) * wld);
                const float4 w2 = *reinterpret_cast<const float4*>(ws + (4 * kq + 2) * wld);
                const float4 w3 = *reinterpret_cast<const float4*>(ws + (4 * kq + 3) * wld);
#pragma unroll
                for (int i = 0; i < TR; ++i) {
                    fma4(acc[i], a[i].x, w0);
                    fma4(acc[i], a[i].y, w1);
                    fma4(acc[i], a[i].z, w2);
                    fma4(acc[i], a[i].w, w3);
                }
            }
        }
        // the last chunk's slot (and the bias in it) is overwritten only
        // after the next piece's first barrier
        const float* bias = slot + P.kw * (wld + xr);
        if (P.S == 1) {
            if (live) {
                const float4 b = *reinterpret_cast<const float4*>(bias + 4 * ql);
#pragma unroll
                for (int i = 0; i < TR; ++i)
                    store_quad(P, st, g * TR + i, P.qa + ql,
                               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]), b,
                               cluster);
            }
            continue;
        }
        // `red` is free: its last readers finished before this piece's first barrier
        if (live) {
#pragma unroll
            for (int i = 0; i < TR; ++i) {
                *reinterpret_cast<float4*>(red + ((s * st.rb + g * TR + i) * P.qp + ql) * 4) =
                    make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            }
        }
        __syncthreads();
        for (int e = threadIdx.x; e < st.rb * P.qp; e += blockDim.x) {
            const int r = e / P.qp, q = e - r * P.qp;
            float4 v = *reinterpret_cast<const float4*>(red + (r * P.qp + q) * 4);
            for (int sl = 1; sl < P.S; ++sl) {
                const float4 a = *reinterpret_cast<const float4*>(
                    red + ((sl * st.rb + r) * P.qp + q) * 4);
                v.x += a.x;
                v.y += a.y;
                v.z += a.z;
                v.w += a.w;
            }
            store_quad(P, st, r, P.qa + q, v, *reinterpret_cast<const float4*>(bias + 4 * q),
                       cluster);
        }
    }
}

// The first layer from the input sweep's partial sums part[split][row][Np]:
// act(sum over the splits, in split order, + bias), this CTA's slab, into
// every CTA's buffer at d_off.
__device__ void trunk_first_partials(const float* __restrict__ part, int splits, int batch,
                                     int row0, int rows_valid, const float* __restrict__ bias,
                                     int N, int act, int rb, float* dst_local, int ld,
                                     cg::cluster_group& cluster) {
    int q0, q1;
    quad_range(N, (int)cluster.block_rank(), (int)cluster.num_blocks(), q0, q1);
    const int Qc = q1 - q0, Np = pad4(N), n = (int)cluster.num_blocks();
    for (int e = threadIdx.x; e < rb * Qc; e += blockDim.x) {
        const int r = e / Qc, q = q0 + e % Qc;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows_valid) {
            for (int sp = 0; sp < splits; ++sp) {
                const float4 a = *reinterpret_cast<const float4*>(
                    part + ((size_t)sp * batch + row0 + r) * Np + 4 * q);
                v.x += a.x;
                v.y += a.y;
                v.z += a.z;
                v.w += a.w;
            }
        }
        const float4 b = ldg4(bias + 4 * q);
        v = make_float4(activate(v.x + b.x, act), activate(v.y + b.y, act),
                        activate(v.z + b.z, act), activate(v.w + b.w, act));
        for (int k = 0; k < n; ++k) {
            float* dst = cluster.map_shared_rank(dst_local, k);
            *reinterpret_cast<float4*>(dst + r * ld + 4 * q) = v;
        }
    }
}

// Fusion and z from the heads (every CTA computes its own copy of z); rank
// 0 writes mu and logvar of the valid rows.
__device__ void posterior(const Model& m, float* sm, const TrunkSmem& p, int rb, int row0,
                          int rows_valid, bool has_site, int noise, const float* __restrict__ eps,
                          uint64_t seed, long long row_base, float* mu_out, float* lv_out,
                          bool write_out) {
    const int L = m.latent, Lp = pad4(L);
    for (int i = threadIdx.x; i < rb * Lp; i += blockDim.x) {
        const int r = i / Lp, j = i - r * Lp;
        float mm = sm[p.hd + r * 2 * Lp + j];
        float v = sm[p.hd + r * 2 * Lp + Lp + j];
        if (has_site) {
            mm = 0.5f * (mm + sm[p.sd + r * 2 * Lp + j]);
            v = 0.5f * (v + sm[p.sd + r * 2 * Lp + Lp + j]);
        }
        float z = j < L ? mm : 0.0f;
        if (r < rows_valid && j < L) {
            const size_t g = (size_t)(row0 + r) * L + j;
            if (write_out) {
                mu_out[g] = mm;
                lv_out[g] = v;
            }
            if (noise == NOISE_EPS) {
                z = reparameterize(mm, v, eps[g]);
            } else if (noise == NOISE_PHILOX) {
                z = reparameterize(mm, v, philox_normal(seed, (int)(row_base + row0 + r), j));
            }
        }
        sm[p.z + i] = z;
    }
    __syncthreads();
}

// The trunk: one cluster a tile of p.rows rows of the call's p.batch (file
// note). `tables` holds the cluster's PieceTables, rank by rank. With
// p.in_sweep the first layer's sums come from `part`; with p.out_sweep the
// last hidden layer goes to `hid` (batch x pad4(width)) and the output sweep
// computes the output layer.
__global__ void __launch_bounds__(TRUNK_THREADS, 1)
trunk_kernel(Model m, Plan p, const PieceTable* __restrict__ tables,
             const float* __restrict__ x, const int64_t* __restrict__ site,
             const float* __restrict__ eps, int has_site, int noise, uint64_t seed,
             long long row_base, const float* __restrict__ part, float* __restrict__ hid,
             float* __restrict__ recon,
             float* __restrict__ mu_out, float* __restrict__ lv_out) {
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    const TrunkSmem L = trunk_smem(m, p.rows, p.slot_f);
    const int rank = (int)cluster.block_rank();
    const int row0 = (int)(blockIdx.x / cluster.num_blocks()) * p.rows;
    const int rows_valid = min(p.rows, p.batch - row0);
    const int rb = pad4(p.rows), Ep = pad4(m.embed);
    PieceTable* table = reinterpret_cast<PieceTable*>(sm + L.pieces);
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.pieces + PIECE_FLOATS) - SLOTS;

    {
        const int* src = reinterpret_cast<const int*>(tables + rank);
        int* dst = reinterpret_cast<int*>(table);
        for (int i = threadIdx.x; i < (int)(sizeof(PieceTable) / 4); i += blockDim.x)
            dst[i] = __ldg(src + i);
    }
    if (threadIdx.x == 0) {
        for (int i = 0; i < SLOTS; ++i) mbar_init(bars + i);
        mbar_fence_init();
    }
    // this CTA's copy of the tile's embedding rows (zeros past the valid rows)
    if (has_site) {
        for (int i = threadIdx.x; i < rb * Ep; i += blockDim.x) {
            const int r = i / Ep;
            const int64_t s = r < rows_valid ? site[row0 + r] : -1;
            sm[L.es + i] = (s >= 0 && s < m.sites) ? __ldg(m.emb + s * Ep + (i - r * Ep)) : 0.0f;
        }
    }
    __syncthreads();
    Stream st = {table->pc, table->n, sm, sm + L.ring, bars, p.slot_f, x, m.in, row0,
                 rows_valid, rb, recon, hid, 0, 0, 0};
    for (int i = 0; i < SLOTS - 1; ++i) issue(st);
    int cc = 0;
    float* red = sm + L.red;
    const int* ends = table->ends;
    cluster.sync();  // every CTA of the cluster has started before any writes into it

    if (p.in_sweep) {
        trunk_first_partials(part, p.in_splits, p.batch, row0, rows_valid, m.eb[0], m.en[0],
                             ACT_RELU, rb, sm + L.a[0], pad4(m.en[0]), cluster);
    } else {
        run_pieces(0, ends[PH_L0], cc, st, red, cluster);
    }
    cluster.sync();
    if (m.n_enc > 1) {
        run_pieces(ends[PH_L0], ends[PH_L1], cc, st, red, cluster);
        cluster.sync();
    }
    run_pieces(ends[PH_L1], ends[PH_HEADS], cc, st, red, cluster);
    cluster.sync();
    posterior(m, sm, L, rb, row0, rows_valid, has_site != 0, noise, eps, seed, row_base, mu_out,
              lv_out, rank == 0);
    run_pieces(ends[PH_HEADS], ends[PH_D0], cc, st, red, cluster);
    if (m.n_dec > 2) {
        cluster.sync();
        run_pieces(ends[PH_D0], ends[PH_D1], cc, st, red, cluster);
    }
    if (!p.out_sweep) {  // else the last hidden layer went to `hid`, nothing into another CTA
        cluster.sync();
        run_pieces(ends[PH_D1], ends[PH_OUT], cc, st, red, cluster);
    }
    // the last writes into other CTAs came before the last cluster.sync, and
    // every chunk of the stream was waited for
}

// ---------------------------------------------------------------------------
// the sweep

// out[split][r][n] for rows [z SW_ROWS, +SW_ROWS), columns [x SW_COLS,
// +SW_COLS) and inputs [y kps, (y + 1) kps) of x (B, K; row stride ldx) and W
// (K, N; row stride ldw, a multiple of 4): with a bias, act(sum + bias) for
// columns < ncols; without, the raw sum for columns < ncols (a partial that
// the trunk adds). Lane l owns columns 4 l..4 l + 3 of the CTA's 128, warp
// w rows w, w + 8, ..., so a warp's row reads are broadcasts and its weight
// reads one 512-byte line. ALIGNED: x rows and K are multiples of 4 floats
// (16-byte copies); otherwise x is copied a float at a time.
template <bool ALIGNED>
__global__ void __launch_bounds__(SWEEP_THREADS, 2)
sweep_kernel(const float* __restrict__ x, int ldx, int batch, int K, int kps,
             const float* __restrict__ W, int ldw, const float* __restrict__ bias, int ncols,
             int act, float* __restrict__ out, int ldo, size_t split_stride) {
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);  // [2][SW_ROWS][SW_KC]
    float* wsm = xs + 2 * SW_ROWS * SW_KC;        // [2][SW_KC][SW_COLS]
    const int c0 = blockIdx.x * SW_COLS;
    const int k0 = blockIdx.y * kps, k1 = min(K, k0 + kps);
    const int r0 = blockIdx.z * SW_ROWS, nrows = min(SW_ROWS, batch - r0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int chunks = (k1 - k0 + SW_KC - 1) / SW_KC;

    auto stage = [&](int c, int buf) {
        const int kb = k0 + c * SW_KC;
        float* xb = xs + buf * SW_ROWS * SW_KC;
        float* wb = wsm + buf * SW_KC * SW_COLS;
        if (ALIGNED) {
            for (int e = threadIdx.x; e < SW_ROWS * SW_KC / 4; e += SWEEP_THREADS) {
                const int r = e / (SW_KC / 4), k = 4 * (e % (SW_KC / 4));
                const bool ok = r < nrows && kb + k < k1;
                cp_async16(xb + r * SW_KC + k, ok ? x + (size_t)(r0 + r) * ldx + kb + k : x, ok);
            }
        } else {
            for (int e = threadIdx.x; e < SW_ROWS * SW_KC; e += SWEEP_THREADS) {
                const int r = e / SW_KC, k = e % SW_KC;
                const bool ok = r < nrows && kb + k < k1;
                cp_async4(xb + e, ok ? x + (size_t)(r0 + r) * ldx + kb + k : x, ok);
            }
        }
        for (int e = threadIdx.x; e < SW_KC * SW_COLS / 4; e += SWEEP_THREADS) {
            const int k = e / (SW_COLS / 4), c = 4 * (e % (SW_COLS / 4));
            const bool ok = kb + k < k1 && c0 + c < ldw;
            cp_async16(wb + k * SW_COLS + c, ok ? W + (size_t)(kb + k) * ldw + c0 + c : W, ok);
        }
        cp_async_commit();
    };

    float acc[SW_RPW][4];
#pragma unroll
    for (int i = 0; i < SW_RPW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    stage(0, 0);
    for (int c = 0; c < chunks; ++c) {
        if (c + 1 < chunks) {
            stage(c + 1, (c + 1) & 1);
            cp_async_wait_one();
        } else {
            cp_async_wait_all();
        }
        __syncthreads();
        const float* xb = xs + (c & 1) * SW_ROWS * SW_KC;
        const float* wb = wsm + (c & 1) * SW_KC * SW_COLS + 4 * lane;
#pragma unroll 2
        for (int kq = 0; kq < SW_KC / 4; ++kq) {
            const float4 w0 = *reinterpret_cast<const float4*>(wb + (4 * kq + 0) * SW_COLS);
            const float4 w1 = *reinterpret_cast<const float4*>(wb + (4 * kq + 1) * SW_COLS);
            const float4 w2 = *reinterpret_cast<const float4*>(wb + (4 * kq + 2) * SW_COLS);
            const float4 w3 = *reinterpret_cast<const float4*>(wb + (4 * kq + 3) * SW_COLS);
#pragma unroll
            for (int i = 0; i < SW_RPW; ++i) {
                if (warp + SW_WARPS * i < nrows) {
                    const float4 a = *reinterpret_cast<const float4*>(
                        xb + (warp + SW_WARPS * i) * SW_KC + 4 * kq);
                    fma4(acc[i], a.x, w0);
                    fma4(acc[i], a.y, w1);
                    fma4(acc[i], a.z, w2);
                    fma4(acc[i], a.w, w3);
                }
            }
        }
        __syncthreads();  // every thread is done with chunk c's buffers
    }
    float* o = out + blockIdx.y * split_stride;
#pragma unroll
    for (int i = 0; i < SW_RPW; ++i) {
        const int r = warp + SW_WARPS * i;
        if (r >= nrows) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int col = c0 + 4 * lane + c;
            if (col >= ncols) continue;
            const float v = bias != nullptr ? activate(acc[i][c] + __ldg(bias + col), act)
                                            : acc[i][c];
            o[(size_t)(r0 + r) * ldo + col] = v;
        }
    }
}

cudaError_t launch_sweep(bool aligned, dim3 grid, cudaStream_t stream, const float* x, int ldx,
                         int batch, int K, int kps, const float* W, int ldw, const float* bias,
                         int ncols, int act, float* out, int ldo, size_t split_stride) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(SWEEP_THREADS);
    cfg.dynamicSmemBytes = SWEEP_SMEM;
    cfg.stream = stream;
    if (aligned) {
        return cudaLaunchKernelEx(&cfg, sweep_kernel<true>, x, ldx, batch, K, kps, W, ldw, bias,
                                  ncols, act, out, ldo, split_stride);
    }
    return cudaLaunchKernelEx(&cfg, sweep_kernel<false>, x, ldx, batch, K, kps, W, ldw, bias,
                              ncols, act, out, ldo, split_stride);
}

int forward(bool rna2dna, const Model* m, const Plan* p, const void* tables, const float* x,
            const int64_t* site,
            const float* eps, float* recon, float* mu, float* logvar, float* part, float* hid,
            int batch, int has_site, int noise_mode, unsigned long long seed, long long row0,
            void* stream) {
    if (m == nullptr || p == nullptr || tables == nullptr || (m->n_enc == 1) != rna2dna ||
        batch <= 0 || batch > p->batch ||
        (has_site && site == nullptr) || (noise_mode == NOISE_EPS && eps == nullptr) ||
        noise_mode < NOISE_NONE || noise_mode > NOISE_EPS || row0 < 0 ||
        row0 + batch > 2147483647LL || (p->in_sweep && part == nullptr) ||
        (p->out_sweep && hid == nullptr) || p->rows < 1 ||
        p->slot_f < 64 || p->slot_f % 4 != 0 ||
        (size_t)p->trunk_smem != sizeof(float) * (size_t)trunk_smem(*m, p->rows, p->slot_f).total ||
        p->trunk_smem > MAX_SMEM) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaSuccess;
    Plan q = *p;  // the bucket's plan at this call's batch
    q.batch = batch;
    const int clusters = (batch + p->rows - 1) / p->rows;
    const int row_blocks = (batch + SW_ROWS - 1) / SW_ROWS;
    const int e0p = pad4(m->en[0]);
    if (p->in_sweep) {
        const bool aligned = m->in % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
        err = launch_sweep(aligned, dim3(p->in_slabs, p->in_splits, row_blocks), s, x, m->in,
                           batch, m->in, p->in_kps, m->ew[0], e0p, nullptr, e0p, ACT_NONE, part,
                           e0p, (size_t)batch * e0p);
        if (err != cudaSuccess) return (int)err;
    }

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(clusters * CLUSTER);
    cfg.blockDim = dim3(TRUNK_THREADS);
    cfg.dynamicSmemBytes = p->trunk_smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, trunk_kernel, *m, q,
                             reinterpret_cast<const PieceTable*>(tables), x, site, eps, has_site,
                             noise_mode,
                             (uint64_t)seed, row0, (const float*)part, hid, recon, mu, logvar);
    if (err != cudaSuccess) return (int)err;

    if (p->out_sweep) {
        const int l = m->n_dec - 1, kp = pad4(m->dn[l - 1]), out = m->dn[l];
        err = launch_sweep(true, dim3(p->out_slabs, 1, row_blocks), s, hid, kp, batch, kp, kp,
                           m->dw[l], pad4(out), m->db[l], out, m->out_act, recon, out, 0);
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Once a process: the kernels' shared-memory opt-ins. Returns a cudaError_t.
int fused_vae_setup(void) {
    cudaError_t err = cudaFuncSetAttribute(trunk_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(sweep_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SWEEP_SMEM);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(sweep_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SWEEP_SMEM);
    return (int)err;
}

// How many trunk clusters with `smem` bytes a CTA can be resident at once
// (0: the plan cannot launch). Returns a cudaError_t.
int fused_vae_max_clusters(int smem, int* out) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(TRUNK_THREADS);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaOccupancyMaxActiveClusters(out, trunk_kernel, &cfg);
}

// The trunk's piece tables of a plan, one PieceTable a cluster rank, into
// host memory `out` (`bytes` long), for a call with or without a site; the
// caller copies them to the card once per plan. `m` is the model with its
// trunk weights in slab-major order (add_pieces). Returns a cudaError_t.
int fused_vae_tables(const Model* m, const Plan* p, int has_site, void* out, long long bytes) {
    if (m == nullptr || p == nullptr || out == nullptr ||
        (long long)sizeof(PieceTable) * CLUSTER > bytes)
        return (int)cudaErrorInvalidValue;
    PieceTable* t = static_cast<PieceTable*>(out);
    for (int r = 0; r < CLUSTER; ++r) {
        build_pieces(*m, *p, has_site != 0, r, t[r]);
        if (t[r].n > MAX_PIECES) return (int)cudaErrorInvalidValue;
    }
    return (int)cudaSuccess;
}

int fused_vae_table_bytes(void) { return (int)sizeof(PieceTable); }

// tables: the plan's piece tables on the card (fused_vae_tables, for this
// call's has_site); batch: the call's rows, 1 to p->batch; row0: the global
// row of the call's first row, for the drawn noise (0 for a whole cohort);
// x (batch, in) f32; site (batch,) int64 or null; eps (batch, latent) f32 or
// null; outputs recon (batch, out), mu and logvar (batch, latent); part
// (in_splits, batch, pad4(en[0])) f32 with p->in_sweep, else null; hid
// (batch, pad4(last hidden)) f32 with p->out_sweep, else null. Returns a
// cudaError_t.
int rna2dna_fused_forward(const Model* m, const Plan* p, const void* tables, const float* x,
                          const int64_t* site,
                          const float* eps, float* recon, float* mu, float* logvar, float* part,
                          float* hid, int batch, int has_site, int noise_mode,
                          unsigned long long seed, long long row0, void* stream) {
    return forward(true, m, p, tables, x, site, eps, recon, mu, logvar, part, hid, batch,
                   has_site, noise_mode, seed, row0, stream);
}

int dna2rna_fused_forward(const Model* m, const Plan* p, const void* tables, const float* x,
                          const int64_t* site,
                          const float* eps, float* recon, float* mu, float* logvar, float* part,
                          float* hid, int batch, int has_site, int noise_mode,
                          unsigned long long seed, long long row0, void* stream) {
    return forward(false, m, p, tables, x, site, eps, recon, mu, logvar, part, hid, batch,
                   has_site, noise_mode, seed, row0, stream);
}

const char* fused_vae_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
