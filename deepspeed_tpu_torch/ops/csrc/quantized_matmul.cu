// Dequant-GEMM: x (m, k) @ dequant(q, scales) with f32 accumulation, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/quantizer/fused_matmul.py:_qmm_kernel
// (launched by the pallas_call in quantized_matmul). q is int8 (k, n) or
// packed int4 (k/2, n) in the per-group split-half layout (byte row j of a
// group of g rows holds row j in its low nibble and row j + g/2 in its high
// one); scales are f32 (k/g, n). As in the TPU kernel, each weight element is
// dequantized as q * scale[row / g, col] in f32, rounded to x's dtype, and
// multiplied with f32 accumulation; out is f32 (m, n), and the wrapper casts
// it and adds the bias. Any m, n and k, any group dividing k (g = 1
// included), even groups for int4; rows and columns past the edges are masked
// here.
//
// What bounds it on this card. Decode (m of 1 to 16) reads every weight byte
// once for 2m operations: far below the H100's ~295 bf16 operations a byte,
// so device-memory bytes bound it (payload + scales; at BLOOM-7B's fc_in,
// int8, 69 MB, 0.021 ms). Prefill (m = 512) does 1,024 operations a payload
// byte, so the tensor cores' operations bound it (fc_in: 68.7 GFLOP, 0.069 ms).
// So there are two regimes, chosen by the wrapper from m (quantized_matmul in
// ops/quantizer/fused_matmul.py, SKINNY_M):
//
// - skinny (m <= 16): each thread owns 4 adjacent columns and walks its block's
//   slice of the payload rows, one 32-bit load a row (a warp reads 128
//   contiguous bytes of a row), 8 rows requested before any is used so that
//   enough bytes are in flight to cover the memory latency; the scales load
//   once a group; x is read from global memory, the same address in every
//   thread of a warp, so it is one broadcast and hits L1 after its first
//   row. The rows are split across blockIdx.y so that a 4096-column matrix
//   gives several hundred blocks for 132 SMs; the splits write f32 partials,
//   and a second kernel adds them in split order, so the result does not
//   depend on the schedule.
// - tiled (m > 16): a block of 4 warps computes a 64 x 64 tile of out over k
//   tiles of 32: it stages x's tile and dequantizes the weight's tile into
//   shared memory in x's dtype (4 columns a payload word), and fetches the
//   next tile into registers (16-byte x vectors, payload words, scales)
//   while bf16/fp16 run mma.sync m16n8k16 with f32 accumulation (each warp a
//   32 x 32 quarter; B fragments by ldmatrix.trans), or f32 x runs FMAs on
//   the CUDA cores (each thread 8 x 4 outputs). The k tiles run in order in
//   the block. Each m tile dequantizes the weight tile again.
//
// Later work: wider payload loads, cp.async/TMA pipelines, wgmma, larger m
// tiles, and a CUDA graph of the decode step that calls it 180 times at 7B.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int SKINNY_M = 16;        // the wrapper's regime switch (fused_matmul.SKINNY_M)
constexpr int SK_THREADS = 128;
constexpr int SK_COLS = 4;          // columns a skinny thread owns
constexpr int SK_BATCH = 8;         // payload rows a skinny thread loads before it uses them
constexpr int TL_THREADS = 128;
constexpr int BM = 64, BN = 64, BK = 32;

// the two signed nibbles of a packed int4 byte `b`, sign-extended to int: the
// low nibble is the group's first-half row, the high nibble its second-half row
__device__ __forceinline__ int nib_lo(int b) { return ((b & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int nib_hi(int b) { return b >> 4; }

// the bits of one element, low-aligned in a 32-bit word
__device__ __forceinline__ uint32_t raw_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t raw_bits(__half v) { return __half_as_ushort(v); }
__device__ __forceinline__ uint32_t raw_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// byte c (0..3) of a 32-bit word, sign-extended
__device__ __forceinline__ int byte_of(uint32_t w, int c) { return (int)(int8_t)(w >> (8 * c)); }

// ----------------------------------------------------------------- skinny
// Payload rows [r0, r1) of this block's split; dst = out + split * m * n.
template <typename T, int M, int BITS>
__global__ void __launch_bounds__(SK_THREADS)
qmm_skinny(const T* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
           float* __restrict__ out, int m, int k, int n, int group, int prow, int chunk) {
    const int c0 = (blockIdx.x * SK_THREADS + threadIdx.x) * SK_COLS;
    if (c0 >= n) return;
    const int split = blockIdx.y;
    const int r0 = split * chunk;
    const int r1 = min(r0 + chunk, prow);
    const bool vec = (n & 3) == 0;      // then c0 + 3 < n and a row's 4 bytes are aligned
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
                        for (int c = 0; c < SK_COLS; ++c)
                            w[c] = round_to<T>((float)byte_of(words[u], c) * sc[c]);
#pragma unroll
                        for (int i = 0; i < M; ++i) {
                            const float xv = i < m ? to_f32(x[(size_t)i * k + r + u]) : 0.f;
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
                            wl[c] = round_to<T>((float)nib_lo(b) * sc[c]);
                            wh[c] = round_to<T>((float)nib_hi(b) * sc[c]);
                        }
#pragma unroll
                        for (int i = 0; i < M; ++i) {
                            const float xl = i < m ? to_f32(x[(size_t)i * k + lo]) : 0.f;
                            const float xh = i < m ? to_f32(x[(size_t)i * k + lo + half]) : 0.f;
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
                if (c < ncols) dst[(size_t)i * n + c0 + c] = acc[i][c];
}

// out[e] = sum over the splits of part[split][e], in split order
__global__ void qmm_reduce(const float* __restrict__ part, float* __restrict__ out, int splits,
                           size_t mn) {
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= mn) return;
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) acc += part[(size_t)sp * mn + e];
    out[e] = acc;
}

// ----------------------------------------------------------------- tiled
__device__ __forceinline__ uint32_t ld_pair(const void* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of two neighbouring n8 tiles from a row-major (k, n) tile in
// shared memory: lane l gives the address of row (l % 8) + 8 * ((l / 8) & 1)
// of column block (l / 16); .trans hands each thread the pair (k = 2 tig,
// 2 tig + 1) at n = gid that mma's "col" B operand wants.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// One 64 x 64 tile of out. xs holds x's tile row-major ([row][kk]), ws the
// dequantized weight tile row-major ([kk][col]), both in x's dtype. The next
// k tile's x vectors, payload words and scales are fetched into registers
// while the tensor cores (or FMAs) work on this one.
template <typename T, int BITS>
__global__ void __launch_bounds__(TL_THREADS)
qmm_tiled(const T* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
          float* __restrict__ out, int m, int k, int n, int group, int k_used, int vec_x,
          int vec_q) {
    constexpr bool MMA = !std::is_same<T, float>::value;
    constexpr int VE = 16 / sizeof(T);              // elements of a 16-byte vector
    constexpr int LDX = BK + VE;                    // row strides, in elements: rows stay
    constexpr int LDW = BN + VE;                    // 16-byte aligned, mma reads conflict-free
    constexpr int XV = BM * BK / VE / TL_THREADS;   // x vectors a thread fetches a tile
    constexpr int WR = BK * BN / 4 / TL_THREADS;    // payload words (4 columns) a thread fetches
    // raw bytes: the 16-bit types have constructors, which __shared__ arrays refuse
    __shared__ __align__(16) unsigned char smem[sizeof(T) * (BM * LDX + BK * LDW)];
    T* xs = reinterpret_cast<T*>(smem);
    T* ws = xs + BM * LDX;
    const int tid = threadIdx.x;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int half = group >> 1;

    // x: vector v = tid + i * TL_THREADS is row v / (BK / VE), columns
    // (v % (BK / VE)) * VE ..; weights: thread owns columns 4 * (tid % 16) ..
    // + 3 of rows tid / 16 + 8 i
    const int wc = 4 * (tid & 15), wr0 = tid >> 4;
    uint4 xv[XV];
    uint32_t qw[WR];
    float sc[WR][4];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int i = 0; i < XV; ++i) {
            const int v = tid + i * TL_THREADS;
            const int row = m0 + v / (BK / VE), col = k0 + (v % (BK / VE)) * VE;
            if (vec_x && row < m && col + VE <= k_used) {
                xv[i] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * k + col));
            } else {                                // element by element, masked
                uint32_t wd[4];
#pragma unroll
                for (int w = 0; w < 4; ++w) {
                    wd[w] = 0;
#pragma unroll
                    for (int t = 0; t < 4 / (int)sizeof(T); ++t) {
                        const int j = w * (4 / (int)sizeof(T)) + t;
                        const T e = (row < m && col + j < k_used) ? x[(size_t)row * k + col + j]
                                                                  : from_f32<T>(0.f);
                        wd[w] |= raw_bits(e) << (16 * t);
                    }
                }
                xv[i] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
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
    // registers -> shared memory; the weights dequantized, rounded to x's dtype
    auto stage = [&](int k0) {
#pragma unroll
        for (int i = 0; i < XV; ++i) {
            const int v = tid + i * TL_THREADS;
            *reinterpret_cast<uint4*>(xs + (v / (BK / VE)) * LDX + (v % (BK / VE)) * VE) = xv[i];
        }
#pragma unroll
        for (int i = 0; i < WR; ++i) {
            const int kk = wr0 + 8 * i;
            const int j = (k0 + kk) % group;
            T w[4];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                const int b = byte_of(qw[i], cc);
                const int qv = BITS == 8 ? b : (j < half ? nib_lo(b) : nib_hi(b));
                w[cc] = from_f32<T>((float)qv * sc[i][cc]);
            }
            T* dst = ws + kk * LDW + wc;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) dst[cc] = w[cc];
        }
    };

    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 1, wn = warp & 1, gid = lane >> 2, tig = lane & 3;
    const int ty = tid >> 4, tx = tid & 15;
    float acc[2][4][4];
    float facc[8][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;
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

        if constexpr (MMA) {
#pragma unroll
            for (int ks = 0; ks < BK; ks += 16) {
                uint32_t a[2][4], b[4][2];
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    const T* p = xs + (wm * 32 + mi * 16 + gid) * LDX + ks + tig * 2;
                    a[mi][0] = ld_pair(p);
                    a[mi][1] = ld_pair(p + 8 * LDX);
                    a[mi][2] = ld_pair(p + 8);
                    a[mi][3] = ld_pair(p + 8 * LDX + 8);
                }
#pragma unroll
                for (int np = 0; np < 2; ++np) {
                    uint32_t r[4];
                    const int krow = ks + (lane & 7) + 8 * ((lane >> 3) & 1);
                    const int col = wn * 32 + np * 16 + 8 * (lane >> 4);
                    ldmatrix_x4_trans(r, ws + krow * LDW + col);
                    b[2 * np][0] = r[0], b[2 * np][1] = r[1];
                    b[2 * np + 1][0] = r[2], b[2 * np + 1][1] = r[3];
                }
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int ni = 0; ni < 4; ++ni) mma16816<T>(acc[mi][ni], a[mi], b[ni]);
            }
        } else {
#pragma unroll 8
            for (int kk = 0; kk < BK; ++kk) {
                float xf[8], wf[4];
#pragma unroll
                for (int i = 0; i < 8; ++i) xf[i] = to_f32(xs[(ty + 8 * i) * LDX + kk]);
#pragma unroll
                for (int j = 0; j < 4; ++j) wf[j] = to_f32(ws[kk * LDW + tx + 16 * j]);
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(xf[i], wf[j], facc[i][j]);
            }
        }
    }

    if constexpr (MMA) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = m0 + wm * 32 + mi * 16 + gid + 8 * h;
                    const int col = n0 + wn * 32 + ni * 8 + tig * 2;
                    if (row < m) {
                        if (col < n) out[(size_t)row * n + col] = acc[mi][ni][2 * h];
                        if (col + 1 < n) out[(size_t)row * n + col + 1] = acc[mi][ni][2 * h + 1];
                    }
                }
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int row = m0 + ty + 8 * i, col = n0 + tx + 16 * j;
                if (row < m && col < n) out[(size_t)row * n + col] = facc[i][j];
            }
    }
}

// ----------------------------------------------------------------- dispatch
template <typename T, int BITS>
cudaError_t run(const void* x, const int8_t* q, const float* s, float* out, float* work, int m,
                int k, int n, int group, int chunk, cudaStream_t stream) {
    const int k_used = k;                      // the logical rows the product sums over
    const T* xt = static_cast<const T*>(x);
    if (chunk == 0) {
        const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
        if (grid.y > 65535) return cudaErrorInvalidValue;
        // 16-byte x vectors need 16-byte rows; 4-byte payload words and
        // 16-byte scale vectors need n % 4 == 0 and aligned bases
        const int vec_x = k % (16 / (int)sizeof(T)) == 0 && (uintptr_t)x % 16 == 0;
        const int vec_q = n % 4 == 0 && (uintptr_t)q % 4 == 0 && (uintptr_t)s % 16 == 0;
        qmm_tiled<T, BITS><<<grid, TL_THREADS, 0, stream>>>(xt, q, s, out, m, k, n, group, k_used,
                                                            vec_x, vec_q);
        return cudaGetLastError();
    }
    const int prow = BITS == 8 ? k_used : k_used / 2;
    const int splits = max(1, (prow + chunk - 1) / chunk);
    if (splits > 65535) return cudaErrorInvalidValue;
    float* dst = splits == 1 ? out : work;
    const dim3 grid((((n + SK_COLS - 1) / SK_COLS) + SK_THREADS - 1) / SK_THREADS, splits);
    if (m == 1)
        qmm_skinny<T, 1, BITS><<<grid, SK_THREADS, 0, stream>>>(xt, q, s, dst, m, k, n, group,
                                                                prow, chunk);
    else if (m <= 4)
        qmm_skinny<T, 4, BITS><<<grid, SK_THREADS, 0, stream>>>(xt, q, s, dst, m, k, n, group,
                                                                prow, chunk);
    else
        qmm_skinny<T, SKINNY_M, BITS><<<grid, SK_THREADS, 0, stream>>>(xt, q, s, dst, m, k, n,
                                                                       group, prow, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    const size_t mn = (size_t)m * n;
    qmm_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(work, out, splits, mn);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bits(const void* x, const void* q, const void* s, void* out, void* work,
                          int m, int k, int n, int group, int bits, int chunk,
                          cudaStream_t stream) {
    const int8_t* qp = static_cast<const int8_t*>(q);
    const float* sp = static_cast<const float*>(s);
    float* op = static_cast<float*>(out);
    float* wp = static_cast<float*>(work);
    if (bits == 8) return run<T, 8>(x, qp, sp, op, wp, m, k, n, group, chunk, stream);
    if (bits == 4) return run<T, 4>(x, qp, sp, op, wp, m, k, n, group, chunk, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// x: (m, k) contiguous in `dtype`; q: int8 (k, n), or (k/2, n) packed for
// bits 4; scales: f32 (k/group, n); out: f32 (m, n); all contiguous, q 4-byte
// aligned. chunk: 0 for the tiled regime, else the payload rows of each
// skinny split (m <= 16), and work holds cdiv(payload rows, chunk) * m * n
// f32 partials when that is more than one. Returns cudaGetLastError().
extern "C" int quantized_matmul(const void* x, const void* q, const void* s, void* out,
                                void* work, int m, int k, int n, int group, int bits, int chunk,
                                int dtype, void* stream) {
    if (m <= 0 || k <= 0 || n <= 0 || group <= 0 || k % group || chunk < 0 ||
        (bits == 4 && group % 2) || (chunk > 0 && m > SKINNY_M))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DS_F32:
            return (int)dispatch_bits<float>(x, q, s, out, work, m, k, n, group, bits, chunk, st);
        case DS_F16:
            return (int)dispatch_bits<__half>(x, q, s, out, work, m, k, n, group, bits, chunk, st);
        case DS_BF16:
            return (int)dispatch_bits<__nv_bfloat16>(x, q, s, out, work, m, k, n, group, bits,
                                                     chunk, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
