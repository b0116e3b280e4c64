// Dequant-GEMM: x (m, k) @ dequant(q, scales) with f32 accumulation, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/quantizer/fused_matmul.py:_qmm_kernel
// (launched by the pallas_call in quantized_matmul). q is int8 (k, n) or
// packed int4 (k/2, n) in the per-group split-half layout (byte row j of a
// group of g rows holds row j in its low nibble and row j + g/2 in its high
// one); scales are f32 (k/g, n). As in the TPU kernel, each weight element is
// dequantized as q * scale[row / g, col] in f32, rounded to x's dtype, and
// multiplied with f32 accumulation. The epilogue writes out in x's dtype or
// f32; with a bias it writes round(round(acc) + round(bias)), bit for bit
// (x @ w).to(dtype) + bias.to(dtype), so a projection is one launch. Any m,
// n and k, any group dividing k (g = 1 included), even groups for int4.
//
// What bounds it on this card. Decode (m of 1 to 16) reads every weight byte
// once for 2m operations, far below the H100's ~295 bf16 operations a byte:
// device-memory bytes bound it (payload + scales; BLOOM-7B's int8 fc_in, 69
// MB, 0.021 ms). But each weight also costs ~4 instructions to dequantize
// (byte_perm, subtract, scale, round): at int4 (two weights a byte) that is
// most of an SM's issue slots at the memory rate, so int4 decode is bound by
// the CUDA cores first. Prefill (m = 512) does 1,024 operations a payload
// byte: the tensor cores bound it (fc_in: 68.7 GFLOP, 0.069 ms), with the
// dequantization, repeated for each m tile, beside them.
//
// bf16 and fp16 (wgmma_qmm) run on the tensor cores with the product turned
// around, out^T (n x m) = dequant(W)^T (n x k) . x^T (k x m), the layout of
// CUTLASS's mixed-input GEMMs:
// - A block covers 128 output features: two consumer warpgroups of 64
//   (wgmma's M) and one producer warp. m is wgmma's N: 8 or 16 at decode, m
//   tiles of 128 at prefill (the tile picked by qmm_plan in
//   ops/quantizer/fused_matmul.py).
// - The producer streams stages of 128 logical k rows through a ring of full
//   and empty mbarriers, by TMA: the payload (128 int8 rows or 64 int4 byte
//   rows of 128 columns, in the 128-byte swizzle), the scales of the groups
//   the stage touches, and x's rows for its k rows as two 64-column panels in
//   the 128-byte swizzle, K-major: wgmma's B. x rows past m and columns past
//   k lie outside the map and are zero-filled. An int4 stage's panels are x
//   at the low nibbles' rows and at the high nibbles' rows g/2 further, so
//   one payload byte feeds both.
// - A consumer reads its payload with ldmatrix.trans: one 32-bit register
//   holds two features x two k rows. Output features are permuted so that a
//   thread's two A rows (l/4 and l/4 + 8) are neighbouring columns 2(l/4)
//   and 2(l/4) + 1 of its warp's 16. The bytes go to f32 exactly by placing
//   them in the mantissa of 2^23 (byte_perm, then one subtraction), are
//   multiplied by the group's scale in f32, rounded to x's dtype and packed
//   into the register A operand of m64nNk16: the dequantized weight never
//   touches memory.
// - wgmma batches of 4 k-steps are double-buffered in registers: the next
//   batch is dequantized while the tensor cores run the last one
//   (wgmma.wait_group 1), and a stage is released one batch late. No other
//   instruction writes the accumulator while wgmmas are in flight (the first
//   product overwrites it), or ptxas would serialize every wgmma.
// - Where the column and m tiles leave SMs idle (decode), the payload rows
//   split across blocks in whole stages (whole groups where a group spans
//   stages): f32 partials, added in split order by qmm_reduce, which then
//   runs the epilogue.
// - Where a tensor cannot be a TMA map (16-byte row strides and bases), or
//   an int4 stage's low rows span two groups (g/2 not a multiple of 64), the
//   producer warp writes that operand with plain loads in the same swizzled
//   layout, so the consumers do not change. That path is slow (a gathered x
//   at the prefill-g8-int4 check case: 0.58 ms on an H100) and no main path
//   takes it.
//
// float32 keeps the first version's CUDA-core kernels (qmm_skinny for m <= 16,
// split across blocks; qmm_tiled above): wgmma's only f32 input type is TF32,
// which keeps ~10 mantissa bits, while the TPU kernel multiplies in f32.

#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int SKINNY_M = 16;        // f32: the regime switch (fused_matmul.SKINNY_M)
constexpr int SK_THREADS = 128;
constexpr int SK_COLS = 4;          // columns a skinny thread owns
constexpr int SK_BATCH = 8;         // payload rows a skinny thread loads before it uses them
constexpr int TL_THREADS = 128;
constexpr int BM = 64, BN = 64, BK = 32;

// the two signed nibbles of a packed int4 byte `b`, sign-extended to int: the
// low nibble is the group's first-half row, the high nibble its second-half
// row. On a word of four bytes, nib_hi moves each byte's high nibble into the
// low nibble of that byte (the wgmma path masks the rest).
__device__ __forceinline__ int nib_lo(int b) { return ((b & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int nib_hi(int b) { return b >> 4; }

// byte c (0..3) of a 32-bit word, sign-extended
__device__ __forceinline__ int byte_of(uint32_t w, int c) { return (int)(int8_t)(w >> (8 * c)); }

// The epilogue of one output element from its f32 sum: f32 out gets the sum
// (plus the bias); out in T gets the sum rounded to T, then, with a bias,
// the bias rounded to T added and the result rounded again.
template <typename T>
__device__ __forceinline__ float epilogue(float acc, int out_f32, const float* bias, int col) {
    if (out_f32) return bias != nullptr ? acc + bias[col] : acc;
    const float r = round_to<T>(acc);
    return bias != nullptr ? round_to<T>(r + round_to<T>(bias[col])) : r;
}

template <typename T>
__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_f32) {
    if (out_f32)
        static_cast<float*>(out)[i] = v;
    else
        static_cast<T*>(out)[i] = from_f32<T>(v);
}

// ------------------------------------------------------- f32: skinny (m <= 16)
// Payload rows [r0, r1) of this block's split; dst = out + split * m * n; the
// bias (f32 out, one split only) is added as the sums are written.
template <int M, int BITS>
__global__ void __launch_bounds__(SK_THREADS)
qmm_skinny(const float* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
           const float* __restrict__ bias, float* __restrict__ out, int m, int k, int n,
           int group, int prow, int chunk) {
    const int c0 = (blockIdx.x * SK_THREADS + threadIdx.x) * SK_COLS;
    if (c0 >= n) return;
    const int split = blockIdx.y;
    const int r0 = split * chunk;
    const int r1 = min(r0 + chunk, prow);
    // then c0 + 3 < n and a row's 4 bytes are aligned
    const bool vec = (n & 3) == 0 && (uintptr_t)q % 4 == 0;
    const int ncols = min(SK_COLS, n - c0);
    const int half = group >> 1;        // int4: payload rows a group

    float acc[M][SK_COLS];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
        for (int c = 0; c < SK_COLS; ++c) acc[i][c] = 0.f;

    const int rows_a_group = BITS == 8 ? group : half;
    int r = r0;
    while (r < r1) {
        const int G = r / rows_a_group;
        const int rend = min(r1, (G + 1) * rows_a_group);
        float sc[SK_COLS];
#pragma unroll
        for (int c = 0; c < SK_COLS; ++c) sc[c] = c < ncols ? s[(size_t)G * n + c0 + c] : 0.f;
        while (r < rend) {
            // the batch's payload words are all requested before any is used,
            // so each thread keeps SK_BATCH loads in flight
            const int nb = min(SK_BATCH, rend - r);
            uint32_t words[SK_BATCH];
#pragma unroll
            for (int u = 0; u < SK_BATCH; ++u) {
                words[u] = 0;
                if (u < nb) {
                    const int8_t* qr = q + (size_t)(r + u) * n + c0;
                    if (vec) {
                        words[u] = __ldg(reinterpret_cast<const uint32_t*>(qr));
                    } else {
                        for (int c = 0; c < ncols; ++c)
                            words[u] |= (uint32_t)(uint8_t)__ldg(qr + c) << (8 * c);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < SK_BATCH; ++u) {
                if (u < nb) {
                    if (BITS == 8) {
                        float w[SK_COLS];
#pragma unroll
                        for (int c = 0; c < SK_COLS; ++c) w[c] = (float)byte_of(words[u], c) * sc[c];
#pragma unroll
                        for (int i = 0; i < M; ++i) {
                            const float xv = i < m ? x[(size_t)i * k + r + u] : 0.f;
#pragma unroll
                            for (int c = 0; c < SK_COLS; ++c) acc[i][c] = fmaf(xv, w[c], acc[i][c]);
                        }
                    } else {
                        // byte row r + u holds logical rows lo (low nibble) and lo + half
                        const int lo = G * group + (r + u - G * half);
                        float wl[SK_COLS], wh[SK_COLS];
#pragma unroll
                        for (int c = 0; c < SK_COLS; ++c) {
                            const int b = byte_of(words[u], c);
                            wl[c] = (float)nib_lo(b) * sc[c];
                            wh[c] = (float)nib_hi(b) * sc[c];
                        }
#pragma unroll
                        for (int i = 0; i < M; ++i) {
                            const float xl = i < m ? x[(size_t)i * k + lo] : 0.f;
                            const float xh = i < m ? x[(size_t)i * k + lo + half] : 0.f;
#pragma unroll
                            for (int c = 0; c < SK_COLS; ++c)
                                acc[i][c] = fmaf(xh, wh[c], fmaf(xl, wl[c], acc[i][c]));
                        }
                    }
                }
            }
            r += nb;
        }
    }
    float* dst = out + (size_t)split * m * n;
#pragma unroll
    for (int i = 0; i < M; ++i)
        if (i < m)
#pragma unroll
            for (int c = 0; c < SK_COLS; ++c)
                if (c < ncols)
                    dst[(size_t)i * n + c0 + c] = epilogue<float>(acc[i][c], 1, bias, c0 + c);
}

// out[e] = the epilogue of the sum over the splits of part[split][e], added in
// split order, so the result does not depend on the schedule
template <typename T>
__global__ void qmm_reduce(const float* __restrict__ part, void* __restrict__ out,
                           const float* __restrict__ bias, int splits, int n, size_t mn,
                           int out_f32) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= mn) return;
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) acc += part[(size_t)sp * mn + e];
    store_out<T>(out, e, epilogue<T>(acc, out_f32, bias, (int)(e % n)), out_f32);
}

// ----------------------------------------------------------- f32: tiled (m > 16)
// One 64 x 64 tile of out on the CUDA cores. xs holds x's tile row-major
// ([row][kk]), ws the dequantized weight tile row-major ([kk][col]). The next
// k tile's x vectors, payload words and scales are fetched into registers
// while the FMAs work on this one.
template <int BITS>
__global__ void __launch_bounds__(TL_THREADS)
qmm_tiled(const float* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
          const float* __restrict__ bias, float* __restrict__ out, int m, int k, int n,
          int group, int k_used, int vec_x, int vec_q) {
    constexpr int VE = 4;                           // floats of a 16-byte vector
    constexpr int LDX = BK + VE;                    // row strides, in elements: rows stay
    constexpr int LDW = BN + VE;                    // 16-byte aligned
    constexpr int XV = BM * BK / VE / TL_THREADS;   // x vectors a thread fetches a tile
    constexpr int WR = BK * BN / 4 / TL_THREADS;    // payload words (4 columns) a thread fetches
    __shared__ __align__(16) float xs[BM * LDX];
    __shared__ __align__(16) float ws[BK * LDW];
    const int tid = threadIdx.x;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int half = group >> 1;

    // x: vector v = tid + i * TL_THREADS is row v / (BK / VE), columns
    // (v % (BK / VE)) * VE ..; weights: thread owns columns 4 * (tid % 16) ..
    // + 3 of rows tid / 16 + 8 i
    const int wc = 4 * (tid & 15), wr0 = tid >> 4;
    float4 xv[XV];
    uint32_t qw[WR];
    float sc[WR][4];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int i = 0; i < XV; ++i) {
            const int v = tid + i * TL_THREADS;
            const int row = m0 + v / (BK / VE), col = k0 + (v % (BK / VE)) * VE;
            if (vec_x && row < m && col + VE <= k_used) {
                xv[i] = __ldg(reinterpret_cast<const float4*>(x + (size_t)row * k + col));
            } else {                                // element by element, masked
                float e[VE];
#pragma unroll
                for (int j = 0; j < VE; ++j)
                    e[j] = (row < m && col + j < k_used) ? x[(size_t)row * k + col + j] : 0.f;
                xv[i] = make_float4(e[0], e[1], e[2], e[3]);
            }
        }
#pragma unroll
        for (int i = 0; i < WR; ++i) {
            const int L = k0 + wr0 + 8 * i, c = n0 + wc;
            qw[i] = 0;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) sc[i][cc] = 0.f;
            if (L < k_used && c < n) {
                const int G = L / group, j = L - G * group;
                const int brow = BITS == 8 ? L : G * half + (j < half ? j : j - half);
                const int8_t* qp = q + (size_t)brow * n + c;
                const float* sp = s + (size_t)G * n + c;
                if (vec_q) {
                    qw[i] = __ldg(reinterpret_cast<const uint32_t*>(qp));
                    const float4 f = __ldg(reinterpret_cast<const float4*>(sp));
                    sc[i][0] = f.x, sc[i][1] = f.y, sc[i][2] = f.z, sc[i][3] = f.w;
                } else {
                    for (int cc = 0; cc < 4 && c + cc < n; ++cc) {
                        qw[i] |= (uint32_t)(uint8_t)__ldg(qp + cc) << (8 * cc);
                        sc[i][cc] = __ldg(sp + cc);
                    }
                }
            }
        }
    };
    // registers -> shared memory; the weights dequantized
    auto stage = [&](int k0) {
#pragma unroll
        for (int i = 0; i < XV; ++i) {
            const int v = tid + i * TL_THREADS;
            *reinterpret_cast<float4*>(xs + (v / (BK / VE)) * LDX + (v % (BK / VE)) * VE) = xv[i];
        }
#pragma unroll
        for (int i = 0; i < WR; ++i) {
            const int kk = wr0 + 8 * i;
            const int j = (k0 + kk) % group;
            float* dst = ws + kk * LDW + wc;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                const int b = byte_of(qw[i], cc);
                const int qv = BITS == 8 ? b : (j < half ? nib_lo(b) : nib_hi(b));
                dst[cc] = (float)qv * sc[i][cc];
            }
        }
    };

    const int ty = tid >> 4, tx = tid & 15;
    float facc[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) facc[a][b] = 0.f;

    fetch(0);
    for (int k0 = 0; k0 < k_used; k0 += BK) {
        __syncthreads();                       // the previous tile's reads are done
        stage(k0);
        __syncthreads();
        if (k0 + BK < k_used) fetch(k0 + BK);
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
            float xf[8], wf[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) xf[i] = xs[(ty + 8 * i) * LDX + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) wf[j] = ws[kk * LDW + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(xf[i], wf[j], facc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int row = m0 + ty + 8 * i, col = n0 + tx + 16 * j;
            if (row < m && col < n)
                out[(size_t)row * n + col] = epilogue<float>(facc[i][j], 1, bias, col);
        }
}

// ------------------------------------------------ bf16 / fp16: wgmma and TMA

namespace wq {

using namespace hopper;

struct Args {
    const void* x;
    const int8_t* q;
    const float* s;
    const float* bias;      // f32 (n,) or null
    void* out;              // (m, n) in T, or f32 where out_f32
    float* work;            // (splits, m, n) f32 partials where the grid has splits
    int m, k, n, group;
    int prow;               // payload rows summed
    int chunk;              // payload rows a split walks (a multiple of the stage's)
    int rg;                 // payload rows a group: g (int8), g / 2 (int4)
    int sr;                 // scale rows a stage holds
    int smode;              // the scales a stage uses: 0 one row, 1 one a k-step, 2 one a row
    int nst;                // stages of the ring
    int tma;                // operands loaded by TMA: 1 x, 2 payload, 4 scales
    int out_f32;
};

constexpr int NWG = 2;                  // consumer warpgroups a block: 128 output features

template <int BITS, int N> struct Tile {
    static constexpr int PR = BITS == 8 ? 128 : 64;     // payload rows a stage (128 k rows)
    static constexpr int PAY = PR * 128;                // payload bytes a stage: 128 columns
    static constexpr int LOADS = PR / 32;               // ldmatrix.x4 loads a stage
    static constexpr int KPL = BITS == 8 ? 2 : 4;       // k-steps a load of 32 payload rows
    static constexpr int BATCH = 4 / KPL;               // loads a wgmma batch of 4 k-steps
    static constexpr int KPB = KPL * BATCH;             // k-steps a batch
    // the A registers alternate between two batches in flight, so a stage
    // holds an even number of batches
    static_assert(LOADS % (2 * BATCH) == 0, "an even number of wgmma batches a stage");
};

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

// shared-memory writes of this thread, made visible to wgmma's operand reads
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wg_wait1() {
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// four 8 x 8 matrices of 16-bit pairs, transposed: lane l gives the address
// of row l % 8 of matrix l / 8; register i holds, of matrix i, rows 2(l%4) and
// 2(l%4) + 1 (low first) of 16-bit column l / 4
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

template <int R> __device__ __forceinline__ void reg_fence_k(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the swizzle TMA writes into 128-byte rows: 16-byte chunk bits [4, 7) XOR
// the row bits [7, 10)
__device__ __forceinline__ int swz128(int o) { return o ^ (((o >> 7) & 7) << 4); }

__device__ __forceinline__ uint32_t bits16(__half v) { return __half_as_ushort(v); }
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// byte i of a word of biased values (int8: q + 128, int4: q + 8) as the f32
// 2^23 + value, exact: the byte in the low mantissa bits of 2^23
__device__ __forceinline__ float biased_f32(uint32_t u, int i) {
    return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i));
}

// Two A-fragment registers from one word of biased payload values, bytes
// (row r, f), (row r, f + 1), (row r + 1, f), (row r + 1, f + 1): feature f's
// pair (rows r, r + 1, low first) and feature f + 1's, each value q * scale in
// f32 rounded to T; `off` removes the bias and 2^23 exactly.
template <typename T>
__device__ __forceinline__ void deq_word(uint32_t u, float off, float2 s0, float2 s1,
                                         uint32_t& af, uint32_t& af1) {
    const float q0 = biased_f32(u, 0) - off, q1 = biased_f32(u, 1) - off;
    const float q2 = biased_f32(u, 2) - off, q3 = biased_f32(u, 3) - off;
    af = pack2<T>(q0 * s0.x, q2 * s1.x);
    af1 = pack2<T>(q1 * s0.y, q3 * s1.y);
}

template <typename T, int BITS, int N>
__global__ void __launch_bounds__(128 * NWG + 32, N <= 16 ? 2 : 1)
wgmma_qmm(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_s, const Args a) {
    using C = Tile<BITS, N>;
    constexpr int PR = C::PR, PAY = C::PAY;
    constexpr int XP = N * 128;                         // bytes of an x panel: N rows of 64
    const int sc_bytes = (a.sr * 512 + 1023) & ~1023;   // scales: sr rows of 128 columns
    const int stage_bytes = PAY + 2 * XP + sc_bytes;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t ring = (raw + 1023) & ~1023u;
    uint8_t* ring_p = smem_raw + (ring - raw);
    const uint32_t bars = ring + a.nst * stage_bytes;   // full[nst], then empty[nst]
    auto full = [&](int s) { return bars + 8 * s; };
    auto empty = [&](int s) { return bars + 8 * (a.nst + s); };

    const int m0 = blockIdx.x * N;
    const int c0 = blockIdx.y * 128;
    const int p_begin = blockIdx.z * a.chunk;
    const int p_end = min(p_begin + a.chunk, a.prow);
    const int n_st = max(p_end - p_begin + PR - 1, 0) / PR;

    if (threadIdx.x == 0) {
        for (int s = 0; s < a.nst; ++s) {
            mbar_init(full(s), 32);
            mbar_init(empty(s), 128 * NWG);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x >= 128 * NWG) {
        // producer warp: lane 0 issues the TMA loads, every lane the plain ones
        const int lane = threadIdx.x & 31;
        const int half = a.group / 2;
        const int groups = a.k / a.group;
        for (int it = 0; it < n_st; ++it) {
            const int s = it % a.nst;
            if (it >= a.nst) mbar_wait(empty(s), (it / a.nst - 1) & 1);
            const int P0 = p_begin + it * PR;
            const int g0 = P0 / a.rg;
            const uint32_t st = ring + s * stage_bytes;
            uint8_t* stp = ring_p + s * stage_bytes;
            // x's k rows of the panels: int8 P0 .., P0 + 64 ..; int4 the low
            // nibbles' rows of a stage inside one group, and g/2 further
            int lo0 = P0;
            bool x_tma = a.tma & 1;
            if (BITS == 4) {
                const int G = P0 / half;
                lo0 = G * a.group + P0 - G * half;
                x_tma = x_tma && (min(P0 + PR, a.prow) - 1) / half == G;
            }
            const bool q_tma = a.tma & 2, s_tma = a.tma & 4;
            if (lane == 0) {
                mbar_expect_tx(full(s), (x_tma ? 2 * XP : 0) + (q_tma ? PAY : 0) +
                                            (s_tma ? a.sr * 512 : 0));
                if (x_tma) {
                    tma_load_2d(st + PAY, &tm_x, full(s), lo0, m0);
                    tma_load_2d(st + PAY + XP, &tm_x, full(s), BITS == 8 ? lo0 + 64 : lo0 + half,
                                m0);
                }
                if (q_tma) tma_load_2d(st, &tm_q, full(s), c0, P0);
                if (s_tma) tma_load_2d(st + PAY + 2 * XP, &tm_s, full(s), c0, g0);
            }
            if (!x_tma) {
                // 16-byte chunks of 8 slots: panel p, row r, slots 8 j8 ..
                const T* x = static_cast<const T*>(a.x);
                for (int ch = lane; ch < 16 * N; ch += 32) {
                    const int p = ch / (8 * N), r = (ch / 8) % N, j8 = ch % 8;
                    const int row = m0 + r;
                    uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        const int P = BITS == 8 ? P0 + 64 * p + 8 * j8 + e : P0 + 8 * j8 + e;
                        int L = P;
                        if (BITS == 4) {
                            const int G = P / half;
                            L = G * a.group + P - G * half + p * half;
                        }
                        if (row < a.m && P < a.prow)
                            v[e / 2] |= bits16(x[(size_t)row * a.k + L]) << (16 * (e % 2));
                    }
                    *reinterpret_cast<uint4*>(stp + PAY + p * XP + swz128(r * 128 + 16 * j8)) =
                        make_uint4(v[0], v[1], v[2], v[3]);
                }
            }
            if (!q_tma) {
                for (int ch = lane; ch < PR * 8; ch += 32) {
                    const int r = ch / 8, cc = ch % 8;
                    const int P = P0 + r, col = c0 + 16 * cc;
                    uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
                    for (int e = 0; e < 16; ++e)
                        if (P < a.prow && col + e < a.n)
                            v[e / 4] |= (uint32_t)(uint8_t)a.q[(size_t)P * a.n + col + e]
                                        << (8 * (e % 4));
                    *reinterpret_cast<uint4*>(stp + swz128(r * 128 + 16 * cc)) =
                        make_uint4(v[0], v[1], v[2], v[3]);
                }
            }
            if (!s_tma) {
                float* sd = reinterpret_cast<float*>(stp + PAY + 2 * XP);
                for (int ch = lane; ch < a.sr * 32; ch += 32) {
                    const int r = ch / 32, cc = ch % 32;
                    const int G = g0 + r, col = c0 + 4 * cc;
                    float4 v;
                    float* ve = reinterpret_cast<float*>(&v);
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        ve[e] = G < groups && col + e < a.n ? a.s[(size_t)G * a.n + col + e] : 0.f;
                    *reinterpret_cast<float4*>(sd + r * 128 + 4 * cc) = v;
                }
            }
            if (!(x_tma && q_tma && s_tma)) fence_proxy_async();
            mbar_arrive(full(s));
        }
    } else {
        // consumer warpgroup wg: output features c0 + 64 wg ..
        const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
        const int warp = tid / 32, lane = tid % 32, t = lane % 4;
        const int fl = 64 * wg + 16 * warp + 2 * (lane / 4);   // this thread's features fl, +1
        // ldmatrix: lane l gives payload row l of a 32-row load, its warp's
        // 16-byte chunk (4 wg + warp) of the 128-byte row, in the 128-byte swizzle
        const uint32_t ld_off = lane * 128 + 16 * ((4 * wg + warp) ^ (lane & 7));
        constexpr float OFF = BITS == 8 ? 8388736.f : 8388616.f;   // 2^23 + 128, 2^23 + 8

        // no instruction but a wgmma may write the accumulator while wgmmas
        // are in flight (ptxas would serialize them): the first product
        // overwrites it instead of a zero fill, and asm fences keep the
        // compiler's own moves out of the pipeline
        float acc[N / 2];
        bool accumulate = false;
        uint32_t ab[2][C::KPB][4];                      // A of two batches in flight
        int rel = -1;                                   // the stage to release one batch late

        for (int it = 0; it < n_st; ++it) {
            const int s = it % a.nst;
            mbar_wait(full(s), (it / a.nst) & 1);
            const uint32_t st = ring + s * stage_bytes;
            const uint32_t xb = st + PAY;
            const float* sc =
                reinterpret_cast<const float*>(ring_p + s * stage_bytes + PAY + 2 * XP) + fl;
            const int P0 = p_begin + it * PR;
            const int g0 = P0 / a.rg;
            // the scale pair of (stage-relative) payload row r
            auto scale_of = [&](int r) {
                return *reinterpret_cast<const float2*>(sc + ((P0 + r) / a.rg - g0) * 128);
            };
            const float2 s_stage = *reinterpret_cast<const float2*>(sc);
#pragma unroll
            for (int b = 0; b < C::LOADS / C::BATCH; ++b) {
                uint32_t(&A)[C::KPB][4] = ab[b & 1];
#pragma unroll
                for (int u = 0; u < C::BATCH; ++u) {
                    const int c = b * C::BATCH + u;         // the load: payload rows 32c ..
                    uint32_t v[4];
                    ldsm_x4_trans(v, st + c * 4096 + ld_off);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {            // the load's two 16-row k-steps
                        const int r = 32 * c + 16 * h;
                        float2 sv[4];                        // rows r + 2t, +1, + 8 + 2t, + 9 + 2t
                        if (a.smode == 0) {
                            sv[0] = sv[1] = sv[2] = sv[3] = s_stage;
                        } else if (a.smode == 1) {
                            sv[0] = sv[1] = sv[2] = sv[3] = scale_of(r);
                        } else {
                            sv[0] = scale_of(r + 2 * t), sv[1] = scale_of(r + 2 * t + 1);
                            sv[2] = scale_of(r + 8 + 2 * t), sv[3] = scale_of(r + 9 + 2 * t);
                        }
                        const uint32_t w0 = v[2 * h], w1 = v[2 * h + 1];
                        uint32_t(&L)[4] = A[C::KPL * u + h];
                        if constexpr (BITS == 8) {
                            deq_word<T>(w0 ^ 0x80808080u, OFF, sv[0], sv[1], L[0], L[1]);
                            deq_word<T>(w1 ^ 0x80808080u, OFF, sv[2], sv[3], L[2], L[3]);
                        } else {
                            // k-step h of the low nibbles, then of the high ones
                            uint32_t(&H)[4] = A[C::KPL * u + 2 + h];
                            const uint32_t l0 = (w0 ^ 0x88888888u) & 0x0F0F0F0Fu;
                            const uint32_t l1 = (w1 ^ 0x88888888u) & 0x0F0F0F0Fu;
                            const uint32_t h0 =
                                ((uint32_t)nib_hi((int)w0) ^ 0x08080808u) & 0x0F0F0F0Fu;
                            const uint32_t h1 =
                                ((uint32_t)nib_hi((int)w1) ^ 0x08080808u) & 0x0F0F0F0Fu;
                            deq_word<T>(l0, OFF, sv[0], sv[1], L[0], L[1]);
                            deq_word<T>(l1, OFF, sv[2], sv[3], L[2], L[3]);
                            deq_word<T>(h0, OFF, sv[0], sv[1], H[0], H[1]);
                            deq_word<T>(h1, OFF, sv[2], sv[3], H[2], H[3]);
                        }
                    }
                }
                reg_fence_k(acc);
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < C::KPB; ++kk) {
                    // load c = b BATCH + kk / KPL; int8: k-step 2c + kk % 2 of the
                    // stage, panel (2c + kk % 2) / 4; int4: k-step 2c + kk % 2 of
                    // the low (panel 0) or high (panel 1) rows
                    const int c = b * C::BATCH + kk / C::KPL, j = kk % C::KPL;
                    const int ks = 2 * c + j % 2;
                    const int panel = BITS == 8 ? ks / 4 : j / 2;
                    mma_rs_k<T, N>(acc, A[kk], desc(xb + panel * XP + 32 * (ks % 4)),
                                   accumulate || kk > 0);
                }
                accumulate = true;
                wg_commit();
                wg_wait1();
                reg_fence_k(acc);
                if (b == 0 && rel >= 0) mbar_arrive(empty(rel));
            }
            rel = s;
        }
        wg_wait0();
        reg_fence_k(acc);
        if (!accumulate)
#pragma unroll
            for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

        // epilogue: accumulator element 4j + e is feature fl + (e >> 1) of the
        // block, row m0 + 8j + 2t + (e & 1) of x
        const int fa = c0 + fl;
        const bool split = gridDim.z > 1;
        const bool pair = (a.n & 1) == 0 && fa + 1 < a.n;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
                const int mr = m0 + 8 * j + 2 * t + b;
                if (mr >= a.m || fa >= a.n) continue;
                const float v0 = acc[4 * j + b], v1 = acc[4 * j + 2 + b];
                if (split) {
                    float* w = a.work + ((size_t)blockIdx.z * a.m + mr) * a.n + fa;
                    if (pair) {
                        *reinterpret_cast<float2*>(w) = make_float2(v0, v1);
                    } else {
                        w[0] = v0;
                        if (fa + 1 < a.n) w[1] = v1;
                    }
                    continue;
                }
                const size_t i = (size_t)mr * a.n + fa;
                const float r0 = epilogue<T>(v0, a.out_f32, a.bias, fa);
                if (pair && !a.out_f32) {
                    const float r1 = epilogue<T>(v1, a.out_f32, a.bias, fa + 1);
                    *reinterpret_cast<uint32_t*>(static_cast<T*>(a.out) + i) = pack2<T>(r0, r1);
                } else {
                    store_out<T>(a.out, i, r0, a.out_f32);
                    if (fa + 1 < a.n)
                        store_out<T>(a.out, i + 1, epilogue<T>(v1, a.out_f32, a.bias, fa + 1),
                                     a.out_f32);
                }
            }
    }
}

// A 2-D tiled map (cols innermost) of `rows` rows `pitch` bytes apart, or
// cudaErrorNotSupported where TMA cannot describe it: a base or pitch that is
// not a multiple of 16 bytes. Encoding a map costs the host more than the
// launch, and a decode step launches this kernel for every projection, so
// maps are kept in a small table keyed by every argument of the encoding: a
// hit is the map the encoding would give.
struct MapKey {
    const void* base;
    uint64_t cols, rows, pitch;
    uint32_t box_cols, box_rows;
    int type, swizzle;
    bool operator==(const MapKey& o) const {
        return base == o.base && cols == o.cols && rows == o.rows && pitch == o.pitch &&
               box_cols == o.box_cols && box_rows == o.box_rows && type == o.type &&
               swizzle == o.swizzle;
    }
};
struct MapEntry {
    MapKey key;
    CUtensorMap map;
    bool valid;
};
constexpr int MAP_SLOTS = 1024;
MapEntry map_table[MAP_SLOTS];
std::mutex map_lock;

inline cudaError_t make_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                               uint64_t cols, uint64_t rows, uint64_t pitch, uint32_t box_cols,
                               uint32_t box_rows, CUtensorMapSwizzle swizzle) {
    if ((uintptr_t)base % 16 || pitch % 16) return cudaErrorNotSupported;
    const MapKey key{base, cols, rows, pitch, box_cols, box_rows, (int)type, (int)swizzle};
    const size_t slot = (((uintptr_t)base >> 4) * 0x9E3779B97F4A7C15ull ^ cols * 31 ^ rows * 131 ^
                         box_rows * 7 ^ (size_t)type) % MAP_SLOTS;
    {
        std::lock_guard<std::mutex> guard(map_lock);
        if (map_table[slot].valid && map_table[slot].key == key) {
            *map = map_table[slot].map;
            return cudaSuccess;
        }
    }
    EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {pitch};
    const cuuint32_t box[2] = {box_cols, box_rows};
    const cuuint32_t elem[2] = {1, 1};
    CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
    std::lock_guard<std::mutex> guard(map_lock);
    map_table[slot] = MapEntry{key, *map, true};
    return cudaSuccess;
}

constexpr int SMEM_LIMIT = 232448;      // a block's dynamic shared memory on the H100
constexpr int MAX_STAGES = 4;

template <typename T, int BITS, int N>
cudaError_t launch(Args a, int splits, cudaStream_t stream) {
    using C = Tile<BITS, N>;
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    // scale rows a stage of PR payload rows (starting at a multiple of PR) can touch
    a.sr = a.rg % C::PR == 0 ? 1 : C::PR % a.rg == 0 ? C::PR / a.rg : min(C::PR, C::PR / a.rg + 2);
    a.smode = a.rg % C::PR == 0 ? 0 : a.rg % 16 == 0 ? 1 : 2;
    const int stage_bytes = C::PAY + 2 * N * 128 + ((a.sr * 512 + 1023) & ~1023);
    a.nst = min(MAX_STAGES, (SMEM_LIMIT - 1024) / (stage_bytes + 16));
    if (a.nst < 2) return cudaErrorInvalidValue;
    const size_t smem = 1024 + (size_t)a.nst * (stage_bytes + 16);

    CUtensorMap mx{}, mq{}, ms{};
    const int groups = a.k / a.group;
    a.tma = 0;
    cudaError_t err = make_map_2d(&mx, a.x, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                                  a.k, a.m, (uint64_t)a.k * sizeof(T), 64, N,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess) a.tma |= 1;
    else if (err != cudaErrorNotSupported) return err;
    err = make_map_2d(&mq, a.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.n, a.prow, a.n, 128, C::PR,
                      CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess) a.tma |= 2;
    else if (err != cudaErrorNotSupported) return err;
    err = make_map_2d(&ms, a.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.n, groups,
                      (uint64_t)a.n * 4, 128, a.sr, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess) a.tma |= 4;
    else if (err != cudaErrorNotSupported) return err;

    static size_t smem_set = 0;                 // the attribute, once an instantiation
    if (smem > smem_set) {
        err = cudaFuncSetAttribute(wgmma_qmm<T, BITS, N>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        smem_set = smem;
    }
    const dim3 grid((a.m + N - 1) / N, (a.n + 127) / 128, splits);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    wgmma_qmm<T, BITS, N><<<grid, 128 * NWG + 32, smem, stream>>>(mx, mq, ms, a);
    return cudaGetLastError();
}

}  // namespace wq

// ----------------------------------------------------------------- dispatch
struct Call {
    const void* x;
    const int8_t* q;
    const float* s;
    const float* bias;
    void* out;
    float* work;
    int m, k, n, group, tile_m, chunk, out_f32;
};

template <typename T>
cudaError_t reduce(const Call& c, int splits, cudaStream_t stream) {
    const size_t mn = (size_t)c.m * c.n;
    qmm_reduce<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(c.work, c.out, c.bias, splits,
                                                                    c.n, mn, c.out_f32);
    return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t run(const Call& c, cudaStream_t stream) {
    const int k = c.k, group = c.group;
    const int k_used = k;                      // the logical rows the product sums over
    const int prow = BITS == 8 ? k_used : k_used / 2;
    const int splits = c.chunk > 0 ? max(1, (prow + c.chunk - 1) / c.chunk) : 1;
    if (splits > 65535) return cudaErrorInvalidValue;
    const float* bias = splits == 1 ? c.bias : nullptr;    // else qmm_reduce adds it
    cudaError_t err;
    if constexpr (std::is_same<T, float>::value) {
        const float* x = static_cast<const float*>(c.x);
        float* dst = splits == 1 ? static_cast<float*>(c.out) : c.work;
        if (c.chunk == 0) {
            const dim3 grid((c.n + BN - 1) / BN, (c.m + BM - 1) / BM);
            if (grid.y > 65535) return cudaErrorInvalidValue;
            // 16-byte x vectors need 16-byte rows; 4-byte payload words and
            // 16-byte scale vectors need n % 4 == 0 and aligned bases
            const int vec_x = c.k % 4 == 0 && (uintptr_t)c.x % 16 == 0;
            const int vec_q = c.n % 4 == 0 && (uintptr_t)c.q % 4 == 0 && (uintptr_t)c.s % 16 == 0;
            qmm_tiled<BITS><<<grid, TL_THREADS, 0, stream>>>(x, c.q, c.s, bias, dst, c.m, k, c.n,
                                                             group, k_used, vec_x, vec_q);
        } else {
            const dim3 grid((((c.n + SK_COLS - 1) / SK_COLS) + SK_THREADS - 1) / SK_THREADS,
                            splits);
            if (c.m == 1)
                qmm_skinny<1, BITS><<<grid, SK_THREADS, 0, stream>>>(
                    x, c.q, c.s, bias, dst, c.m, c.k, c.n, c.group, prow, c.chunk);
            else if (c.m <= 4)
                qmm_skinny<4, BITS><<<grid, SK_THREADS, 0, stream>>>(
                    x, c.q, c.s, bias, dst, c.m, c.k, c.n, c.group, prow, c.chunk);
            else
                qmm_skinny<SKINNY_M, BITS><<<grid, SK_THREADS, 0, stream>>>(
                    x, c.q, c.s, bias, dst, c.m, c.k, c.n, c.group, prow, c.chunk);
        }
        err = cudaGetLastError();
    } else {
        wq::Args a{c.x, c.q, c.s, bias, c.out, c.work, c.m, k, c.n, group, prow,
                   c.chunk > 0 ? c.chunk : prow, BITS == 8 ? group : group / 2,
                   0, 0, 0, 0, c.out_f32};
        if (c.tile_m == 8)
            err = wq::launch<T, BITS, 8>(a, splits, stream);
        else if (c.tile_m == 16)
            err = wq::launch<T, BITS, 16>(a, splits, stream);
        else
            err = wq::launch<T, BITS, 128>(a, splits, stream);
    }
    if (err != cudaSuccess || splits == 1) return err;
    return reduce<T>(c, splits, stream);
}

template <typename T>
cudaError_t dispatch_bits(const Call& c, int bits, cudaStream_t stream) {
    if (bits == 8) return run<T, 8>(c, stream);
    if (bits == 4) return run<T, 4>(c, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// x: (m, k) contiguous in `dtype`; q: int8 (k, n), or (k/2, n) packed for
// bits 4; scales: f32 (k/group, n); bias: f32 (n,) or null; out: (m, n) in
// `dtype`, or f32 where out_f32; all contiguous. tile_m: the plan's rows of x
// a block covers (bf16/fp16: 8, 16 or 128; f32: 0, the regime following m).
// chunk: the payload rows of each k-split, 0 for one (bf16/fp16: a multiple
// of the stage's 128 int8 or 64 int4 rows; f32: only for m <= 16); work
// holds cdiv(payload rows, chunk) * m * n f32 partials when that is more than
// one. Returns cudaGetLastError().
extern "C" int quantized_matmul(const void* x, const void* q, const void* s, const void* bias,
                                void* out, void* work, int m, int k, int n, int group, int bits,
                                int tile_m, int chunk, int dtype, int out_f32, void* stream) {
    if (m <= 0 || k <= 0 || n <= 0 || group <= 0 || k % group || chunk < 0 ||
        (bits == 4 && group % 2))
        return (int)cudaErrorInvalidValue;
    const bool wide = dtype == DS_F16 || dtype == DS_BF16;
    if (wide ? (tile_m != 8 && tile_m != 16 && tile_m != 128) || chunk % (bits == 8 ? 128 : 64)
             : tile_m != 0 || (chunk > 0 && m > SKINNY_M) || !out_f32)
        return (int)cudaErrorInvalidValue;
    const Call c{x, static_cast<const int8_t*>(q), static_cast<const float*>(s),
                 static_cast<const float*>(bias), out, static_cast<float*>(work),
                 m, k, n, group, tile_m, chunk, out_f32};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DS_F32:
            return (int)dispatch_bits<float>(c, bits, st);
        case DS_F16:
            return (int)dispatch_bits<__half>(c, bits, st);
        case DS_BF16:
            return (int)dispatch_bits<__nv_bfloat16>(c, bits, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
