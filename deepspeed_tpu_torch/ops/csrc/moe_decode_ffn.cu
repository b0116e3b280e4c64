// Selected-expert FFN for MoE decode, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/moe/decode_ffn.py:_kernel
// (launched by the pallas_call in moe_decode_ffn). For each of n tokens
// (n = batch x top-k at a decode step) with expert id idx[i]:
//
//   y_i = act(x_i @ w1[idx_i] + b1[idx_i]) @ w2[idx_i] + b2[idx_i]
//
// x (n, d), stacked w1 (e, d, f), b1 (e, f), w2 (e, f, d), b2 (e, d), all in
// one dtype (f32, fp16 or bf16); idx (n,) int32; y f32 (n, d), gate weights
// applied by the caller. Numerics as in the TPU kernel: both products take
// exact products of the stored values with f32 sums; b1 is added and the
// activation (gelu tanh, relu or silu) applied in f32; h is rounded once to
// the weights' dtype before the second product; b2 is added in f32, then the
// f-blocks' partial outputs in a fixed order. Any n, d, f and e; an expert id
// outside [0, e) is clamped (ids come from an argmax, so this never fires).
//
// What bounds it on this card. Each token reads its expert's w1 and w2 once
// for 4 d f operations: 2 operations a weight element, far below the H100's
// ~295 bf16 operations a byte, so device-memory bytes bound it. At GPT-2
// 125M with 8 experts (d 768, f 3072, bf16), one expert is 9.44 MB: 2.8 us
// at 3.35 TB/s, which only a card full of bytes in flight approaches.
//
// Every call is two launches: an FFN kernel writes f32 partial outputs, one
// a (token, f-block), to part (n, nfb, d), and moe_ffn_reduce adds them: y_i
// = b2[idx_i] + the sums over thread groups g of (the partials of f-blocks
// j = g, g + 8, ... in order), g in order. No atomics touch values, so two
// calls give the same bits. The FFN kernel is one of two:
//
// - moe_ffn_mma, the tensor-core kernel: 16-bit stacks, d and f multiples
//   of 8, f-blocks of 8, 16 or 32, shared memory (mma_layout, about 80 d
//   bytes) within the block's 227 KB (the wrapper takes it for one or two
//   tokens; with more, the slab kernel was as fast or faster on the H100).
//   Grid (n, cdiv(f, bf)); block (i, j) takes the f-block [j bf, j bf + nf)
//   of token i's expert over all of d. Thread 0 asks for both slabs at once
//   by TMA: w1's column slab (d x bf, in boxes of 64 rows, each on its own
//   mbarrier) first, then w2's row slab (bf x d, in 64-column boxes of
//   128-byte swizzled rows, on one mbarrier), all marked first to leave L2;
//   the token's x row comes in beside its expert id. The products run on the
//   tensor cores (mma.sync m16n8k16, f32 sums of exact products; the token
//   is row 0 of A, rows 1..15 zero): for h the 8 warps split d's 16-row
//   steps in turn and their sums meet in shared memory in warp order; for
//   the output each warp owns 8-column tiles of d (with bf 8 the second half
//   of w2's box and of h is zero). At GPT-2 MoE's shape and n = 1, bf 16
//   gives 192 blocks of 48 KB of slabs, all requested at once. Every block
//   waits on all of its barriers before it exits. The reduction is then
//   launched as its programmatic dependent, so its launch overlaps the FFN.
// - moe_ffn_slab, the first version's kernel, for every other call (f32,
//   other shapes, more tokens): grid (n, cdiv(f, bf)), 256 threads; block
//   (i, j) stages x_i in shared memory as f32, asks L2 for w2's slab,
//   computes h over w1's column slab (each thread one 16-byte column vector
//   and a strided set of its d rows, 8 rows requested before any is used;
//   the row groups meet in shared memory in a fixed order), rounds h, and
//   writes h @ w2's slab. Blocks of one f-block for all tokens run together,
//   so tokens that share an expert find its slabs in L2.

#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_BLOCK_F = 256;
constexpr int W1_BOX_ROWS = 64;      // rows of a w1 box, one mbarrier each
constexpr int W2_BOX_COLS = 64;      // columns of a w2 box: 128-byte rows
constexpr int XPRE = 2;              // 16-byte pieces of a token's x row a thread loads early
constexpr int UNROLL = 8;            // rows a thread requests before it uses them (slab kernel)
constexpr int RED_COLS = 32, RED_GROUPS = 8;   // the reduction's block: 32 columns x 8
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 227 * 1024;

enum DsAct { DS_GELU = 0, DS_RELU = 1, DS_SILU = 2 };

__device__ __forceinline__ float act_fn(float v, int act) {
    if (act == DS_GELU) {   // tanh approximation, as jax.nn.gelu(approximate=True)
        const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
        return 0.5f * v * (1.f + tanhf(inner));
    }
    if (act == DS_RELU) return fmaxf(v, 0.f);
    return v / (1.f + expf(-v));
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ int expert_of(const int* idx, int i, int e) {
    return min(max(__ldg(idx + i), 0), e - 1);
}

struct Params {
    const void* x;
    const int* idx;
    const void* w1;
    const void* b1;
    const void* w2;
    const void* b2;
    float* part;    // (n, nfb, d) f32
    float* y;       // (n, d) f32
    int n, d, f, e, bf, nfb, act;
};

// ------------------------------------------------------------ the reduction

// y[i, col] = b2[idx_i, col] + the sums over g of (the sum over the f-blocks
// j = g, g + 8, ..., in order, of part[i, j, col]), g in order. Grid
// (cdiv(d, 32), n), blocks of (32, 8): thread (c, g) = (t % 32, t / 32).
// Waits for the FFN launch it depends on where that was launched with it as
// a programmatic dependent.
template <typename T>
__global__ void __launch_bounds__(RED_COLS * RED_GROUPS)
moe_ffn_reduce(const float* __restrict__ part, const int* __restrict__ idx,
               const T* __restrict__ b2, float* __restrict__ y, int d, int e, int nfb) {
    __shared__ float sums[RED_GROUPS][RED_COLS];
    const int i = blockIdx.y, ex = expert_of(idx, i, e);
    const int t = threadIdx.x + threadIdx.y * RED_COLS, c = t % RED_COLS, g = t / RED_COLS;
    const int col = blockIdx.x * RED_COLS + c;
    const int nfb_used = nfb;
    asm volatile("griddepcontrol.wait;" ::: "memory");
    float s = 0.f;
    if (col < d) {
        const float* p = part + (size_t)i * nfb * d + col;
        for (int j = g; j < nfb_used; j += RED_GROUPS) s += __ldcg(p + (size_t)j * d);
    }
    sums[g][c] = s;
    __syncthreads();
    if (g == 0 && col < d) {
        float v = to_f32(b2[(size_t)ex * d + col]);
        for (int gg = 0; gg < RED_GROUPS; ++gg) v += sums[gg][c];
        y[(size_t)i * d + col] = v;
    }
}

// ------------------------------------------------------ the tensor-core path

// one box of the 2-D map at (column c0, row c1) into shared memory at dst,
// marked first to leave L2: an expert's weights are read once a step, and
// the lines they would displace are worth more
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, uint64_t policy) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "l"(policy)
        : "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
    return policy;
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
                 : "=r"(r0), "=r"(r1)
                 : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
                 : "=r"(r0), "=r"(r1)
                 : "r"(addr));
}

// d += a (16 x 16, row) x b (16 x 8, col), f32 sums of exact products; rows
// 8..15 of a are zero (its registers a1 and a3)
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
    const uint32_t z = 0;
    if constexpr (std::is_same<T, __half>::value)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a0), "r"(z), "r"(a2), "r"(z), "r"(b0), "r"(b1));
    else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a0), "r"(z), "r"(a2), "r"(z), "r"(b0), "r"(b1));
}

// rows 0..7 of A at columns k0..k0+15 of a row-major 8 x ld tile of 16-bit
// values at base: a0 (columns k0..k0+7) and a2 (k0+8..k0+15)
__device__ __forceinline__ void load_a(uint32_t& a0, uint32_t& a2, uint32_t base, int ld, int k0) {
    const int lane = threadIdx.x & 31;
    ldsm_x2(base + (uint32_t)(((lane & 7) * ld + k0 + ((lane >> 3) & 1) * 8) * 2), a0, a2);
}

// the rows of w2's box room and of the second product's k extent: 16 at
// least, the rows past bf zero
__host__ __device__ __forceinline__ int k_rows(int bf) { return bf < 16 ? 16 : bf; }

__host__ __device__ inline size_t take(size_t& at, size_t bytes, size_t align) {
    at = (at + align - 1) / align * align;
    const size_t start = at;
    at += bytes;
    return start;
}

// Shared memory of moe_ffn_mma, bytes from the 1024-aligned start: w2's
// boxes (cdiv(d, 64) of k_rows(bf) rows x 128 bytes), w1's boxes (cdiv(d,
// 64) of 64 rows x bf), x (8 x (d + 8) of T: rows 0..7 of A, the token row
// 0), the warps' sums of h (8 x bf f32), h (8 x (k_rows(bf) + 8) of T), b1's
// slice (f32), the barriers. ops/moe/decode_ffn.py:mma_smem_bytes mirrors it.
struct MmaLayout {
    size_t w2, w1, xa, red, ha, b1, bars, total;
};

__host__ __device__ inline MmaLayout mma_layout(int d, int bf) {
    MmaLayout L;
    size_t at = 0;
    const int nb = cdiv(d, W1_BOX_ROWS), kr = k_rows(bf);
    L.w2 = take(at, (size_t)cdiv(d, W2_BOX_COLS) * kr * 128, 1024);
    L.w1 = take(at, (size_t)nb * W1_BOX_ROWS * bf * 2, 1024);
    L.xa = take(at, (size_t)8 * (d + 8) * 2, 16);
    L.red = take(at, (size_t)WARPS * bf * 4, 16);
    L.ha = take(at, (size_t)8 * (kr + 8) * 2, 16);
    L.b1 = take(at, (size_t)bf * 4, 16);
    L.bars = take(at, (size_t)(nb + 1) * 8, 8);
    L.total = at + 1024;     // room to align the start
    return L;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
moe_ffn_mma(const __grid_constant__ CUtensorMap map1, const __grid_constant__ CUtensorMap map2,
            const Params p) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    asm volatile("griddepcontrol.launch_dependents;");
    const int i = blockIdx.x, j = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    const uint4* xg = reinterpret_cast<const uint4*>(static_cast<const T*>(p.x) + (size_t)i * p.d);

    // the token's x row comes in beside its expert id
    const int ex = expert_of(p.idx, i, p.e);
    uint4 xq[XPRE];
#pragma unroll
    for (int q = 0; q < XPRE; ++q) {
        const int o = t + q * THREADS;
        xq[q] = o * 8 < p.d ? __ldg(xg + o) : make_uint4(0, 0, 0, 0);
    }
    const int f0 = j * p.bf, nf = min(p.bf, p.f - f0);
    const int nb = cdiv(p.d, W1_BOX_ROWS), nq = cdiv(p.d, W2_BOX_COLS), kr = k_rows(p.bf);

    const MmaLayout L = mma_layout(p.d, p.bf);
    const uint32_t w2a = hopper::smem_addr(smem + L.w2), w1a = hopper::smem_addr(smem + L.w1);
    T* xa = reinterpret_cast<T*>(smem + L.xa);
    float* red = reinterpret_cast<float*>(smem + L.red);
    T* ha = reinterpret_cast<T*>(smem + L.ha);
    float* b1s = reinterpret_cast<float*>(smem + L.b1);
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
    const uint32_t xaa = hopper::smem_addr(xa), haa = hopper::smem_addr(ha);
    // both slabs requested at once, w1's first: its rows [64 b, 64 b + 64) of
    // columns [f0, f0 + bf) on bars[b], then w2's rows [f0, f0 + bf) of
    // columns [64 q, 64 q + 64) on bars[nb]. A box also brings columns or
    // rows past the slab (the next f-block's, never used) and zeros past the
    // stack's end; all its bytes count on its barrier.
    if (t == 0) {
        for (int b = 0; b <= nb; ++b) hopper::mbar_init(hopper::smem_addr(&bars[b]), 1);
        hopper::mbar_fence_init();
        const uint64_t policy = evict_first_policy();
        const uint32_t box1 = W1_BOX_ROWS * p.bf * 2;
        for (int b = 0; b < nb; ++b) {
            const uint32_t bar = hopper::smem_addr(&bars[b]);
            hopper::mbar_arrive_expect_tx(bar, box1);
            tma_load_2d(w1a + b * box1, &map1, bar, f0, ex * p.d + b * W1_BOX_ROWS, policy);
        }
        const uint32_t bar = hopper::smem_addr(&bars[nb]);
        hopper::mbar_arrive_expect_tx(bar, nq * p.bf * 128);
        for (int q = 0; q < nq; ++q)
            tma_load_2d(w2a + q * kr * 128, &map2, bar, q * W2_BOX_COLS, ex * p.f + f0, policy);
    }
    // with bf 8, rows 8..15 of each w2 box (the second half of the second
    // product's 16-row step) are zero, never written by the copy
    if (p.bf < 16)
        for (int o = t; o < nq * 64; o += THREADS)
            reinterpret_cast<uint4*>(smem + L.w2 + (o >> 6) * kr * 128 + 1024)[o & 63] =
                make_uint4(0, 0, 0, 0);
    const T* b1 = static_cast<const T*>(p.b1) + (size_t)ex * p.f + f0;
    for (int c = t; c < nf; c += THREADS) b1s[c] = to_f32(b1[c]);

    // x as row 0 of A (zero past d), rows 1..7 zero
    const int xl = p.d + 8, xv = xl / 8;       // x's rows in A: 16-byte pieces apart
    uint4* xa4 = reinterpret_cast<uint4*>(xa);
    for (int o = t; o < 8 * xv; o += THREADS) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (o < xv && o * 8 < p.d) {
            if (o < XPRE * THREADS) {
#pragma unroll
                for (int q = 0; q < XPRE; ++q)
                    if (o == t + q * THREADS) v = xq[q];
            } else {
                v = __ldg(xg + o);
            }
        }
        xa4[o] = v;
    }
    __syncthreads();

    // h's sums: warp w takes d's 16-row steps [w ks / 8, (w + 1) ks / 8),
    // for each 8-column tile of the f-block (w1's rows bf x 2 bytes apart;
    // with bf 32, 64-byte rows in the 64-byte swizzle: piece c of row r at c
    // ^ ((r / 2) % 4)). Every box has a step, so every barrier is waited on.
    const int ks_all = cdiv(p.d, 16), nt1 = p.bf / 8, g = lane >> 2;
    float acc[4][4] = {};
    for (int ks = warp * ks_all / WARPS; ks < (warp + 1) * ks_all / WARPS; ++ks) {
        hopper::mbar_wait(hopper::smem_addr(&bars[ks * 16 / W1_BOX_ROWS]), 0);
        uint32_t a0, a2;
        load_a(a0, a2, xaa, xl, ks * 16);
        const int r = ks * 16 + (lane & 15);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
            if (nt < nt1) {
                const int piece = p.bf == 32 ? nt ^ ((r >> 1) & 3) : nt;
                uint32_t b0, b1r;
                ldsm_x2_trans(w1a + (uint32_t)(r * p.bf * 2 + piece * 16), b0, b1r);
                mma16816<T>(acc[nt], a0, a2, b0, b1r);
            }
    }
    // row 0 of each warp's sums (lanes 0..3)
    if (g == 0)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
            if (nt < nt1) {
                const int c = nt * 8 + 2 * lane;
                red[warp * p.bf + c] = acc[nt][0];
                red[warp * p.bf + c + 1] = acc[nt][1];
            }
    __syncthreads();
    // h: the warps' sums in order, b1, the activation, one rounding; as row 0
    // of a kr-wide A for the second product, zero past nf and in rows 1..7
    const int hl = kr + 8;
    for (int o = t; o < 8 * kr; o += THREADS) {
        const int mm = o / kr, c = o % kr;
        float s = 0.f;
        if (mm == 0 && c < nf) {
            for (int w = 0; w < WARPS; ++w) s += red[w * p.bf + c];
            s = act_fn(s + b1s[c], p.act);
        }
        ha[mm * hl + c] = from_f32<T>(s);
    }
    __syncthreads();
    // the partial output: warp w owns d's 8-column tiles w, w + 8, ..., over
    // the kr / 16 steps of the f-block's rows
    uint32_t a0[2], a2[2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
        if (ks * 16 < kr) load_a(a0[ks], a2[ks], haa, hl, ks * 16);
    hopper::mbar_wait(hopper::smem_addr(&bars[nb]), 0);
    float* dst = p.part + ((size_t)i * p.nfb + j) * p.d;
    for (int nt = warp; nt < cdiv(p.d, 8); nt += WARPS) {
        float out[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
            if (ks * 16 < kr) {
                const int r = ks * 16 + (lane & 15);
                uint32_t b0, b1r;
                ldsm_x2_trans(w2a + (uint32_t)((nt >> 3) * kr * 128 + r * 128 +
                                               (((nt & 7) ^ (r & 7)) << 4)),
                              b0, b1r);
                mma16816<T>(out, a0[ks], a2[ks], b0, b1r);
            }
        if (g == 0)
            *reinterpret_cast<float2*>(dst + 8 * nt + 2 * lane) = make_float2(out[0], out[1]);
    }
}

// -------------------------------------------------------- the slab kernel

// VEC elements of T as raw storage: one 16-byte load, or one element
template <typename T, int VEC> struct Raw { uint4 u; };
template <typename T> struct Raw<T, 1> { T u; };

template <typename T, int VEC> __device__ __forceinline__ Raw<T, VEC> ldv(const T* p) {
    Raw<T, VEC> r;
    if constexpr (VEC == 1) r.u = p[0];
    else r.u = __ldg(reinterpret_cast<const uint4*>(p));
    return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void fma_vec(float (&acc)[VEC], float s, const Raw<T, VEC>& r) {
    const T* e = reinterpret_cast<const T*>(&r.u);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = fmaf(s, to_f32(e[k]), acc[k]);
}

// acc[k] += sum over rows r = r0, r0 + stride, ... < rows of s[r] * w[r * ld + k]
template <typename T, int VEC>
__device__ __forceinline__ void rows_dot(float (&acc)[VEC], const float* s, const T* w,
                                         int r0, int stride, int rows, size_t ld) {
    int r = r0;
    for (; r + (UNROLL - 1) * stride < rows; r += UNROLL * stride) {
        Raw<T, VEC> raw[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) raw[u] = ldv<T, VEC>(w + (size_t)(r + u * stride) * ld);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) fma_vec<T, VEC>(acc, s[r + u * stride], raw[u]);
    }
    for (; r < rows; r += stride) fma_vec<T, VEC>(acc, s[r], ldv<T, VEC>(w + (size_t)r * ld));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
moe_ffn_slab(const T* __restrict__ x, const int* __restrict__ idx, const T* __restrict__ w1,
             const T* __restrict__ b1, const T* __restrict__ w2, float* __restrict__ part,
             int d, int f, int e, int bf, int act) {
    extern __shared__ float smem[];
    float* xs = smem;                 // d: x_i in f32
    float* hs = xs + d;               // bf: h rounded to T, as f32
    float* red = hs + bf;             // THREADS * VEC: partial sums of the row groups
    const int i = blockIdx.x, j = blockIdx.y, nfb = gridDim.y, t = threadIdx.x;
    const int ex = expert_of(idx, i, e);
    const int f0 = j * bf;
    const int nf = min(bf, f - f0);

    // w2's slab, rows [f0, f0 + nf) of d: one contiguous range; into L2 now
    const T* w2e = w2 + ((size_t)ex * f + f0) * d;
    {
        const char* p = reinterpret_cast<const char*>(w2e);
        const size_t bytes = (size_t)nf * d * sizeof(T);
        for (size_t off = (size_t)t * 128; off < bytes; off += (size_t)THREADS * 128)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(p + off));
    }
    for (int c = t; c < d; c += THREADS) xs[c] = to_f32(x[(size_t)i * d + c]);
    __syncthreads();

    // h = x_i @ w1[ex][:, f0 : f0 + nf]: thread (g, c) sums column vector c
    // over rows g, g + G, ...
    {
        const int cv = nf / VEC;                  // nf is a multiple of VEC
        const int G = THREADS / cv;
        const int g = t / cv, c = t % cv;
        if (g < G) {
            float acc[VEC] = {};
            rows_dot<T, VEC>(acc, xs, w1 + (size_t)ex * d * f + f0 + c * VEC, g, G, d, f);
#pragma unroll
            for (int k = 0; k < VEC; ++k) red[g * nf + c * VEC + k] = acc[k];
        }
        __syncthreads();
        for (int col = t; col < nf; col += THREADS) {
            float s = 0.f;
            for (int gg = 0; gg < G; ++gg) s += red[gg * nf + col];
            s += to_f32(b1[(size_t)ex * f + f0 + col]);
            hs[col] = round_to<T>(act_fn(s, act));
        }
        __syncthreads();
    }

    // part[i, j] = h @ w2[ex][f0 : f0 + nf, :]
    float* dst = part + ((size_t)i * nfb + j) * d;
    const int cvd = d / VEC;                      // d is a multiple of VEC
    if (cvd >= THREADS) {
        for (int c = t; c < cvd; c += THREADS) {
            float acc[VEC] = {};
            rows_dot<T, VEC>(acc, hs, w2e + c * VEC, 0, 1, nf, d);
#pragma unroll
            for (int k = 0; k < VEC; ++k) dst[c * VEC + k] = acc[k];
        }
    } else {
        const int G = THREADS / cvd;
        const int g = t / cvd, c = t % cvd;
        if (g < G) {
            float acc[VEC] = {};
            rows_dot<T, VEC>(acc, hs, w2e + c * VEC, g, G, nf, d);
#pragma unroll
            for (int k = 0; k < VEC; ++k) red[g * d + c * VEC + k] = acc[k];
        }
        __syncthreads();
        for (int col = t; col < d; col += THREADS) {
            float s = 0.f;
            for (int gg = 0; gg < G; ++gg) s += red[gg * d + col];
            dst[col] = s;
        }
    }
}

// ---------------------------------------------------------------- launches

// A 2-D map over a stacked weight of `rows` rows of `cols` 16-bit values,
// boxes of box_cols x box_rows. Encoding costs the host more than the
// launch, and every decode step launches K7 a MoE layer, so maps are kept in
// a small table keyed by every argument of the encoding.
struct MapKey {
    const void* base;
    uint64_t cols, rows;
    uint32_t box_cols, box_rows;
    int type, swizzle;
    bool operator==(const MapKey& o) const {
        return base == o.base && cols == o.cols && rows == o.rows && box_cols == o.box_cols &&
               box_rows == o.box_rows && type == o.type && swizzle == o.swizzle;
    }
};
struct MapEntry {
    MapKey key;
    CUtensorMap map;
    bool valid;
};
constexpr int MAP_SLOTS = 256;
MapEntry map_table[MAP_SLOTS];
std::mutex map_lock;

cudaError_t make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, uint64_t cols,
                     uint64_t rows, uint32_t box_cols, uint32_t box_rows,
                     CUtensorMapSwizzle swizzle) {
    const MapKey key{base, cols, rows, box_cols, box_rows, (int)type, (int)swizzle};
    const size_t slot = (((uintptr_t)base >> 4) * 0x9E3779B97F4A7C15ull ^ cols * 31 ^ rows * 131 ^
                         box_cols * 7 ^ box_rows) %
                        MAP_SLOTS;
    {
        std::lock_guard<std::mutex> guard(map_lock);
        if (map_table[slot].valid && map_table[slot].key == key) {
            *map = map_table[slot].map;
            return cudaSuccess;
        }
    }
    hopper::EncodeTiledFn encode = hopper::encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols * 2};
    const cuuint32_t box[2] = {box_cols, box_rows};
    const cuuint32_t elem[2] = {1, 1};
    CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
    std::lock_guard<std::mutex> guard(map_lock);
    map_table[slot] = MapEntry{key, *map, true};
    return cudaSuccess;
}

// the reduction, as a programmatic dependent of the FFN kernel where pdl
template <typename T>
cudaError_t launch_reduce(const Params& p, bool pdl, cudaStream_t st) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cdiv(p.d, RED_COLS), (unsigned)p.n, 1);
    cfg.blockDim = dim3(RED_COLS, RED_GROUPS, 1);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, moe_ffn_reduce<T>, (const float*)p.part, p.idx,
                                         static_cast<const T*>(p.b2), p.y, p.d, p.e, p.nfb);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma(const Params& p, cudaStream_t st) {
    const size_t smem = mma_layout(p.d, p.bf).total;
    if (smem > SMEM_MAX || p.nfb > 65535) return cudaErrorInvalidValue;
    const CUtensorMapDataType type = std::is_same<T, __half>::value
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    CUtensorMap m1, m2;
    cudaError_t err = make_map(&m1, p.w1, type, p.f, (uint64_t)p.e * p.d, p.bf, W1_BOX_ROWS,
                               p.bf == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess)
        err = make_map(&m2, p.w2, type, p.d, (uint64_t)p.e * p.f, W2_BOX_COLS, p.bf,
                       CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(moe_ffn_mma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    moe_ffn_mma<T><<<dim3((unsigned)p.n, (unsigned)p.nfb), THREADS, smem, st>>>(m1, m2, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_reduce<T>(p, true, st);
}

template <typename T, int VEC>
cudaError_t launch_slab(const Params& p, cudaStream_t st) {
    if (p.nfb > 65535) return cudaErrorInvalidValue;
    const size_t smem = (size_t)(p.d + p.bf + THREADS * VEC) * sizeof(float);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    if (smem > SMEM_DEFAULT) {
        cudaError_t err = cudaFuncSetAttribute(
            reinterpret_cast<const void*>(&moe_ffn_slab<T, VEC>),
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    moe_ffn_slab<T, VEC><<<dim3(p.n, p.nfb), THREADS, smem, st>>>(
        static_cast<const T*>(p.x), p.idx, static_cast<const T*>(p.w1),
        static_cast<const T*>(p.b1), static_cast<const T*>(p.w2), p.part, p.d, p.f, p.e, p.bf,
        p.act);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_reduce<T>(p, false, st);
}

template <typename T>
cudaError_t dispatch(Params p, int mode, cudaStream_t st) {
    constexpr int V = 16 / (int)sizeof(T);
    const bool vec = p.d % V == 0 && p.f % V == 0 && p.bf % V == 0 &&
                     (uintptr_t)p.w1 % 16 == 0 && (uintptr_t)p.w2 % 16 == 0;
    p.nfb = cdiv(p.f, p.bf);
    if (mode == 0) return vec ? launch_slab<T, V>(p, st) : launch_slab<T, 1>(p, st);
    // the tensor-core kernel: 16-bit values, rows whole 16-byte pieces (as
    // a TMA map needs), f-blocks of 8, 16 or 32
    if constexpr (sizeof(T) == 2) {
        if (!vec || (p.bf != 8 && p.bf != 16 && p.bf != 32)) return cudaErrorInvalidValue;
        return launch_mma<T>(p, st);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// x (n, d), w1 (e, d, f), b1 (e, f), w2 (e, f, d), b2 (e, d): contiguous, in
// `dtype`; idx (n,) int32; part: f32 scratch of n * cdiv(f, block_f) * d;
// y: f32 (n, d). block_f in [1, 256]. mode: 0 the slab kernel, 1 the
// tensor-core kernel (16-bit stacks, d, f and block_f multiples of 8, 16-byte
// aligned stacks, block_f 8, 16 or 32, mma_layout within 227 KB, else
// cudaErrorInvalidValue). act: 0 gelu (tanh), 1 relu, 2 silu. Launches the
// FFN kernel and the reduction on `stream`; returns cudaGetLastError().
extern "C" int moe_decode_ffn(const void* x, const void* idx, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* part, void* y, int n, int d,
                              int f, int e, int block_f, int mode, int act, int dtype,
                              void* stream) {
    if (n <= 0 || d <= 0 || f <= 0 || e <= 0 || block_f < 1 || block_f > MAX_BLOCK_F ||
        mode < 0 || mode > 1 || act < DS_GELU || act > DS_SILU)
        return (int)cudaErrorInvalidValue;
    Params p{x, static_cast<const int*>(idx), w1, b1, w2, b2, static_cast<float*>(part),
             static_cast<float*>(y), n, d, f, e, block_f, 0, act};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DS_F32: return (int)dispatch<float>(p, mode, st);
        case DS_F16: return (int)dispatch<__half>(p, mode, st);
        case DS_BF16: return (int)dispatch<__nv_bfloat16>(p, mode, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
