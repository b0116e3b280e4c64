// Flash-attention backward, dq, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/flash.py:_bwd_dq_kernel
// (launched by the first pallas_call in _flash_bwd): dq of causal or full
// attention over q/k/v/do (b*h, t, d), recomputing the probabilities tile by
// tile from the forward's f32 logsumexp, so the (t x t) matrices never reach
// device memory. The TPU grid walks kv blocks as its sequential last axis and
// carries dq in VMEM scratch between grid steps; here one block owns q rows
// and walks the kv tiles in a loop, with dq in registers. dk and dv are the
// other kernel's (csrc/flash_bwd_dkv.cu): two kernels, as in the JAX package,
// so no block adds into another's output and the gradients are the same on
// every run.
//
// What bounds it on this card: per causal (row, col) pair it does 6*d
// operations (s = q.k, dp = do.v, dq += ds.k) on 10*t*d bytes per (batch,
// head) (q, k, v, do in, dq out, plus f32 lse and delta), about 0.3*t
// operations a byte: ~300 at the training main path's t = 1024, at the ~295
// bf16 operations a byte where the H100's tensor cores become the limit. On
// the CUDA cores the products alone would take 0.87 ms at the training shape
// (5.8e10 operations at 67 TFLOP/s), twice SDPA's whole backward.
//
// bf16 and fp16 (the kernel wgmma_dq below) run all three products on the
// tensor cores with f32 sums, as the TPU kernel runs them on its MXU. It is
// csrc/flash_fwd.cu's pipeline with a second chain and no online softmax:
// - A block owns 64 q rows per consumer warpgroup (one; two where forced
//   at build time, see dq_warpgroups) of one (b*h), plus one producer
//   warpgroup. Q and dO come in by TMA once and stay in shared memory; each
//   consumer thread keeps its two rows' lse and delta in registers.
// - The producer's first thread streams 64-row K and V tiles by TMA through
//   a ring of stages, each with a full and an empty mbarrier; with two
//   consumer warpgroups, setmaxnreg moves the producer's registers to the
//   consumers.
// - S = Q K^T and dP = dO V^T are two wgmma chains from shared memory (K's
//   and V's rows are K-major for the B operand); S takes the forward's
//   k-steps in the forward's order, so s is the score its lse came from.
// - In registers, on the f32 accumulator fragments: P = exp(S scale + bias -
//   lse), masked to 0 where the TPU kernel masks (cols >= t and, under
//   `causal`, col > row; only on tiles that meet the diagonal or t), and dS =
//   P (dP - delta) scale, rounded to k's dtype (the TPU kernel's rounding).
// - ds is rounded before its product with k, so a last-bit difference in s
//   or dp can flip that rounding, and a flipped ds moves a dq element by
//   ulp(ds) |k|: for a large ds that is above the bf16 limit of
//   kernel_checks where |dq| is small. The tensor cores sum s and dp in
//   another order than an f32 dot product, and any two orders flip a few
//   such roundings against each other. So where the f32 ds (|ds| >= 2^-6)
//   lies within TIE_ULPS f32 ulps of a rounding boundary of T, the kernel
//   recomputes that element from the tiles in shared memory as the first
//   version and a plain f32 evaluation do (FMAs along d in index order, then
//   scale, bias, exp and products rounded one by one) and rounds that value.
//   At most 2 * TIE_ULPS in 2^16 (bf16) or 2^13 (fp16) of those elements
//   take that path.
// - dS is the register A operand of dQ += dS K, K being the MN-major B
//   operand (the transpose bit), one chain per 64-column panel of dq: the p
//   and ds tiles never touch shared memory.
// - dq stays in f32 registers for the block's life and is written once, in
//   q's dtype, up to t. Under `causal` a block stops at its diagonal tile, a
//   warpgroup skips a tile wholly right of its rows (still releasing its
//   stage), and blocks start with the longest q tiles so the triangle's short
//   tail fills the last wave.
// - Tiles are 3-D TMA boxes of (d, t, b*h): a box past t is zero-filled and
//   never reads the next head's rows.
//
// Head dims: built for D 64 and 128, with the real head_dim d (a multiple of
// 8, at most D) at run time, as csrc/flash_fwd.cu: d-wide TMA maps zero-fill
// the columns past d, rows lie d apart, stores stop at d.
//
// float32 keeps the first version's kernel (flash_bwd_dq_kernel) on the CUDA
// cores: wgmma's only f32 input type is TF32 (~10 mantissa bits), while the
// TPU kernel takes f32 products in full f32. The choice is by dtype alone.
//
// Numerics of both kernels follow the TPU kernel and the forward
// (csrc/flash_fwd.cu): s is scaled, biased (ALiBi slope*(col - row)) and
// masked as there, so p = exp(s - lse) is the forward's probability; ds =
// p*(dp - delta)*scale is rounded to the input dtype before the product with
// k, where it lies near a rounding boundary from its in-order value (above);
// dq accumulates in f32 and is written once in q's dtype. Rows and columns
// past t (a ragged last tile) are masked, so any t works.
//
// First version's layout (float32; 256 threads, one 64-row q tile of one
// (batch, head)): thread (ty, tx) = (tid / 16, tid % 16) owns rows 4*ty ..
// 4*ty+3; of each 64-column score tile it computes columns tx + 16*j, and of
// dq the columns tx + 16*c. Shared memory holds q, do, k, v as f32 tiles with
// padded rows and the f32 ds tile: 149 KB at d = 128, so it is dynamic shared
// memory. The next k/v tile is fetched into registers while the current one
// computes.

#include "hopper.cuh"
#include "common.cuh"

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // k/v rows per tile
constexpr int NTHREADS = 256;
constexpr int BKP = BK + 1;     // padded row stride of the ds tile

template <int D>
constexpr size_t smem_bytes() {
    // q, do, k, v tiles [64][D+1] and the ds tile [BQ][BK+1]
    return sizeof(float) * (size_t)(4 * 64 * (D + 1) + BQ * BKP);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ slopes,
                    T* __restrict__ dq, int t, int d, int n_heads, float scale, int causal) {
    extern __shared__ float smem[];
    constexpr int DP = D + 1;
    constexpr int DC = D / 16;          // dq columns per thread
    float* qs = smem;                   // [BQ][DP]
    float* dos = qs + BQ * DP;          // [BQ][DP]
    float* ks = dos + BQ * DP;          // [BK][DP]
    float* vs = ks + BK * DP;           // [BK][DP]
    float* dss = vs + BK * DP;          // [BQ][BKP]

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int q0 = blockIdx.x * BQ;
    const int bh = blockIdx.y;
    const size_t base = (size_t)bh * t * d;      // rows d apart; columns d .. D-1 zero
    const bool use_alibi = slopes != nullptr;
    const float slope = use_alibi ? slopes[bh % n_heads] : 0.f;

    constexpr int VEC = vec_elems<T>();
    constexpr int ROW_VECS = D / VEC;
    constexpr int PER_THREAD = BK * ROW_VECS / NTHREADS;
    static_assert(BK * ROW_VECS % NTHREADS == 0 && BQ == BK, "tiles must split evenly");
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const int vi = tid + i * NTHREADS;
        const int r = vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
        const int row = q0 + r;
        const bool ok = row < t && c < d;
        const size_t idx = base + (size_t)row * d + c;
        store16_f32<T>(qs + r * DP + c, ok ? load16(q + idx) : make_uint4(0u, 0u, 0u, 0u));
        store16_f32<T>(dos + r * DP + c, ok ? load16(dout + idx) : make_uint4(0u, 0u, 0u, 0u));
    }
    float lse_r[4], delta_r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        lse_r[i] = row < t ? lse[(size_t)bh * t + row] : 0.f;
        delta_r[i] = row < t ? delta[(size_t)bh * t + row] : 0.f;
    }

    uint4 kreg[PER_THREAD], vreg[PER_THREAD];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            const int vi = tid + i * NTHREADS;
            const int row = k0 + vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
            const size_t idx = base + (size_t)row * d + c;
            const bool ok = row < t && c < d;
            kreg[i] = ok ? load16(k + idx) : make_uint4(0u, 0u, 0u, 0u);
            vreg[i] = ok ? load16(v + idx) : make_uint4(0u, 0u, 0u, 0u);
        }
    };

    float acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

    int nk = (t + BK - 1) / BK;
    if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);   // stop at the diagonal tile

    fetch(0);
    for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                // the previous tile's k/ds reads are done
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            const int vi = tid + i * NTHREADS;
            const int r = vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
            store16_f32<T>(ks + r * DP + c, kreg[i]);
            store16_f32<T>(vs + r * DP + c, vreg[i]);
        }
        if (kt + 1 < nk) fetch(k0 + BK);
        __syncthreads();

        // s = q k^T and dp = do v^T, summed over d in the forward's order
        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) {
            float qv[4], dv[4], kv[4], vv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                qv[i] = qs[(ty * 4 + i) * DP + c];
                dv[i] = dos[(ty * 4 + i) * DP + c];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                kv[j] = ks[(tx + 16 * j) * DP + c];
                vv[j] = vs[(tx + 16 * j) * DP + c];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
                    dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
                }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            const int row = q0 + r;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = k0 + tx + 16 * j;
                float x = s[i][j] * scale;
                if (use_alibi) x += slope * (float)(col - row);
                const bool valid = row < t && col < t && (!causal || col <= row);
                const float p = valid ? expf(x - lse_r[i]) : 0.f;
                dss[r * BKP + tx + 16 * j] = round_to<T>(p * (dp[i][j] - delta_r[i]) * scale);
            }
        }
        __syncthreads();

        // dq += ds k
#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            float kv[DC];
#pragma unroll
            for (int cc = 0; cc < DC; ++cc) kv[cc] = ks[c * DP + tx + 16 * cc];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float ds = dss[(ty * 4 + i) * BKP + c];
#pragma unroll
                for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(ds, kv[cc], acc[i][cc]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row < t) {
            const size_t off = base + (size_t)row * d;
#pragma unroll
            for (int c = 0; c < DC; ++c)
                if (tx + 16 * c < d) dq[off + tx + 16 * c] = from_f32<T>(acc[i][c]);
        }
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* slopes, void* dq, int bh,
                   int t, int d, int n_heads, float scale, int causal, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((t + BQ - 1) / BQ, bh);
    flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const float*>(slopes),
        static_cast<T*>(dq), t, d, n_heads, scale, causal);
    return cudaGetLastError();
}

// ------------------------------------------------ bf16 / fp16: wgmma and TMA

namespace wg {

using namespace hopper;

constexpr int BK = 64;          // k/v rows per tile
// f32 ulps of its own value within which ds counts as near a rounding
// boundary of T (see the header); DS_FLASH_DQ_TIE_ULPS at build time sets
// another, 0 for none, to time and check what the recompute buys
#ifdef DS_FLASH_DQ_TIE_ULPS
constexpr uint32_t TIE_ULPS = DS_FLASH_DQ_TIE_ULPS;
#else
constexpr uint32_t TIE_ULPS = 256;
#endif

// whether rounding v to T lands within TIE_ULPS of a halfway point, for |v|
// >= 2^-6: bf16 keeps the top 16 bits of an f32, fp16 the top 13 bits of its
// mantissa. Below 2^-6 a flipped rounding moves dq by at most 2^-14 |k|
// (bf16; fp16 2^-17 |k|).
template <typename T>
__device__ __forceinline__ bool near_tie(float v) {
    if (TIE_ULPS == 0) return false;
    const uint32_t b = __float_as_uint(v);
    const uint32_t low = std::is_same<T, __nv_bfloat16>::value ? b & 0xFFFFu : b & 0x1FFFu;
    const uint32_t half = std::is_same<T, __nv_bfloat16>::value ? 0x8000u : 0x1000u;
    return (b & 0x7FFFFFFFu) >= 0x3C800000u && low - (half - TIE_ULPS) <= 2 * TIE_ULPS;
}

// the 8 values at row r, columns c .. c + 7 (c a multiple of 8), of a tile of
// 64-column panels in the 128-byte swizzle that the TMA loads write
__device__ __forceinline__ uint4 swizzled16(const uint8_t* tile, int r, int c) {
    return *reinterpret_cast<const uint4*>(tile + (c / PANEL) * PANEL_BYTES + r * 128 +
                                           ((c % PANEL / 8) ^ (r % 8)) * 16);
}

// s = q.k and dp = do.v of one (row, col) as the first version
// (flash_bwd_dq_kernel) and a plain f32 dot product take them: f32 FMAs along
// d in index order. q and do are row rq of their tiles, k and v row rk.
template <typename T, int D>
__device__ __forceinline__ void dots_in_order(const uint8_t* qt, const uint8_t* dot,
                                              const uint8_t* kt, const uint8_t* vt, int rq,
                                              int rk, float& s, float& dp) {
    constexpr int VEC = vec_elems<T>();
    s = dp = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += VEC) {
        float a[VEC], b[VEC], x[VEC], y[VEC];
        store16_f32<T>(a, swizzled16(qt, rq, c));
        store16_f32<T>(b, swizzled16(kt, rk, c));
        store16_f32<T>(x, swizzled16(dot, rq, c));
        store16_f32<T>(y, swizzled16(vt, rk, c));
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            s = fmaf(a[i], b[i], s);
            dp = fmaf(x[i], y[i], dp);
        }
    }
}

template <int D, int NWG>
struct Cfg {
    static constexpr int NP = D / PANEL;                      // 64-column panels of a row
    static constexpr int NST = D == 64 ? 3 : 2;               // stages of the K/V ring
    static constexpr int THREADS = 128 * (NWG + 1);
    static constexpr int Q_BYTES = NWG * NP * PANEL_BYTES;    // the q tile; dO's is as large
    static constexpr int STAGE_BYTES = 2 * NP * PANEL_BYTES;  // K panels, then V panels
    // 1024 bytes of slack to align the tiles, then q, do, the ring, the barriers
    static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + NST * STAGE_BYTES + 8 * (1 + 2 * NST);
};

template <typename T, int D, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), (NWG == 1 && D == 64) ? 2 : 1)
wgmma_dq(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
         const float* __restrict__ lse, const float* __restrict__ delta,
         const float* __restrict__ slopes, T* __restrict__ dq, int t, int d, int n_heads,
         float scale, int causal) {
    using C = Cfg<D, NWG>;
    constexpr int NP = C::NP, NST = C::NST;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
    auto generic = [&](uint32_t a) { return smem_raw + (a - smem_addr(smem_raw)); };
    const uint32_t do_s = q_s + C::Q_BYTES;
    const uint32_t ring = do_s + C::Q_BYTES;
    const uint32_t q_full = ring + NST * C::STAGE_BYTES;     // then full[NST], empty[NST]
    auto full = [&](int s) { return q_full + 8 * (1 + s); };
    auto empty = [&](int s) { return q_full + 8 * (1 + NST + s); };

    const int bh = blockIdx.x;
    const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;   // longest first
    const int q0 = tile * 64 * NWG;
    const int nk_all = (t + BK - 1) / BK;
    // stop at the diagonal tile
    const int nk = causal ? min(nk_all, (q0 + 64 * NWG - 1) / BK + 1) : nk_all;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < NST; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 128 * NWG);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wgi = threadIdx.x / 128;
    if (wgi == NWG) {
        // producer: one thread issues every load
        if constexpr (NWG == 2) setmaxnreg_dec<40>();
        if (threadIdx.x == 128 * NWG) {
            mbar_arrive_expect_tx(q_full, 2 * C::Q_BYTES);
            for (int w = 0; w < NWG; ++w)
                for (int p = 0; p < NP; ++p) {
                    tma_load_3d(q_s + (w * NP + p) * PANEL_BYTES, &tm_q, q_full, PANEL * p,
                                q0 + 64 * w, bh);
                    tma_load_3d(do_s + (w * NP + p) * PANEL_BYTES, &tm_do, q_full, PANEL * p,
                                q0 + 64 * w, bh);
                }
            for (int kt = 0; kt < nk; ++kt) {
                const int s = kt % NST;
                if (kt >= NST) mbar_wait(empty(s), (kt / NST - 1) & 1);
                mbar_arrive_expect_tx(full(s), C::STAGE_BYTES);
                const uint32_t st = ring + s * C::STAGE_BYTES;
                for (int p = 0; p < NP; ++p) {
                    tma_load_3d(st + p * PANEL_BYTES, &tm_k, full(s), PANEL * p, kt * BK, bh);
                    tma_load_3d(st + (NP + p) * PANEL_BYTES, &tm_v, full(s), PANEL * p, kt * BK,
                                bh);
                }
            }
        }
    } else {
        // consumer warpgroup wgi: q rows row0 .. row0 + 63
        if constexpr (NWG == 2) setmaxnreg_inc<232>();
        const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
        const int row0 = q0 + 64 * wgi;
        const int ra = row0 + 16 * warp + lane / 4;          // this thread's rows: ra, ra + 8
        const float sl2 = scale * LOG2E;                     // scores in log2 units
        const float slope = slopes != nullptr ? slopes[bh % n_heads] : 0.f;
        const float slope2 = slope * LOG2E;
        const uint32_t qw = q_s + wgi * NP * PANEL_BYTES, dow = do_s + wgi * NP * PANEL_BYTES;
        float lse_r[2], lse2[2], dl[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = ra + 8 * i;
            lse_r[i] = row < t ? lse[(size_t)bh * t + row] : 0.f;
            lse2[i] = lse_r[i] * LOG2E;
            dl[i] = row < t ? delta[(size_t)bh * t + row] : 0.f;
        }

        float acc[NP][32];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

        mbar_wait(q_full, 0);
        for (int kt = 0; kt < nk; ++kt) {
            const int s = kt % NST;
            const int k0 = kt * BK;
            mbar_wait(full(s), (kt / NST) & 1);
            if (!causal || k0 <= row0 + 63) {
                const uint32_t ks = ring + s * C::STAGE_BYTES, vs = ks + NP * PANEL_BYTES;
                float sc[32], dp[32];
#pragma unroll
                for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const uint32_t off = (kk / 4) * PANEL_BYTES + 32 * (kk % 4);
                    mma_ss<T, 0>(sc, desc(qw + off), desc(ks + off), kk > 0);
                    mma_ss<T, 0>(dp, desc(dow + off), desc(vs + off), kk > 0);
                }
                wg_commit();
                wg_wait0();
                reg_fence(sc);
                reg_fence(dp);

                const bool mask_causal = causal && k0 + BK - 1 > row0;   // meets the diagonal
                const bool ragged = k0 + BK > t;
                uint32_t ties = 0;          // bit 4j + e: that element's ds is near a tie
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
                        const int row = ra + 8 * (e >> 1);
                        float x = sc[4 * j + e] * sl2;
                        if (slopes != nullptr) x += slope2 * (float)(col - row);
                        bool valid = !ragged || col < t;
                        if (mask_causal) valid = valid && col <= row;
                        const float p = valid ? exp2f(x - lse2[e >> 1]) : 0.f;
                        const float ds = p * (dp[4 * j + e] - dl[e >> 1]) * scale;
                        dp[4 * j + e] = ds;
                        if (near_tie<T>(ds) && row < t) ties |= 1u << (4 * j + e);
                    }
                while (ties) {
                    // ds rounds as its in-order value rounds (see the header)
                    const int i = __ffs(ties) - 1, h = (i >> 1) & 1;
                    ties &= ties - 1;
                    const int row = ra + 8 * h, col = k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
                    float s1, dp1;
                    dots_in_order<T, D>(generic(qw), generic(dow), generic(ks), generic(vs),
                                        row - row0, col - k0, s1, dp1);
                    float x = __fmul_rn(s1, scale);
                    if (slopes != nullptr) x = __fadd_rn(x, __fmul_rn(slope, (float)(col - row)));
                    const float p = expf(__fsub_rn(x, lse_r[h]));
                    const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp1, dl[h])), scale);
#pragma unroll
                    for (int u = 0; u < 32; ++u)
                        if (u == i) dp[u] = ds;
                }
                uint32_t dsa[4][4];
                acc_to_afrag<T>(dp, dsa);          // ds rounded to k's dtype
                wg_fence();
#pragma unroll
                for (int p = 0; p < NP; ++p)
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
                        mma_rs<T, 1>(acc[p], dsa[kk], desc(ks + p * PANEL_BYTES + 2048 * kk));
                wg_commit();
                wg_wait0();
#pragma unroll
                for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
            }
            mbar_arrive(empty(s));          // also for a tile skipped above its rows
        }

#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = ra + 8 * i;
            if (row < t) {
                T* dqrow = dq + ((size_t)bh * t + row) * d;
#pragma unroll
                for (int p = 0; p < NP; ++p)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        if (PANEL * p + 8 * j >= d) continue;     // d is a multiple of 8
                        const int a = 4 * j + 2 * i;
                        *reinterpret_cast<uint32_t*>(dqrow + PANEL * p + 8 * j + 2 * (lane % 4)) =
                            pack2<T>(acc[p][a], acc[p][a + 1]);
                    }
            }
        }
    }
}

// consumer warpgroups a block: one (64 q rows, two blocks an SM at d 64),
// from the sweep in benchmarks/torch/qmm_versions.py: one was faster at every
// case but the training shape, where the two were within the timings'
// spread; DS_FLASH_DQ_WG=1|2 at build time forces one, for that sweep
inline int dq_warpgroups() {
#ifdef DS_FLASH_DQ_WG
    return DS_FLASH_DQ_WG;
#else
    return 1;
#endif
}

template <typename T, int D, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* slopes, void* dq, int bh,
                   int t, int d, int n_heads, float scale, int causal, cudaStream_t stream) {
    using C = Cfg<D, NWG>;
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err;
    // maps d wide: columns past d come in as zeros (flash_fwd.cu)
    if ((err = make_map_3d(&mq, q, bh, t, d, bf16)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mk, k, bh, t, d, bf16)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mv, v, bh, t, d, bf16)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mdo, dout, bh, t, d, bf16)) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(wgmma_dq<T, D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (t + 64 * NWG - 1) / (64 * NWG));
    wgmma_dq<T, D, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const float*>(slopes), static_cast<T*>(dq), t, d, n_heads, scale, causal);
    return cudaGetLastError();
}

}  // namespace wg

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* slopes, void* dq,
                       int bh, int t, int d, int n_heads, float scale, int causal,
                       cudaStream_t stream) {
    const int width = build_width(d, 128);
    if constexpr (std::is_same<T, float>::value) {
        if (width == 64)
            return launch<T, 64>(q, k, v, dout, lse, delta, slopes, dq, bh, t, d, n_heads, scale,
                                 causal, stream);
        if (width == 128)
            return launch<T, 128>(q, k, v, dout, lse, delta, slopes, dq, bh, t, d, n_heads,
                                  scale, causal, stream);
    } else {
        const bool two = wg::dq_warpgroups() == 2;
        if (width == 64)
            return two ? wg::launch<T, 64, 2>(q, k, v, dout, lse, delta, slopes, dq, bh, t, d,
                                              n_heads, scale, causal, stream)
                       : wg::launch<T, 64, 1>(q, k, v, dout, lse, delta, slopes, dq, bh, t, d,
                                              n_heads, scale, causal, stream);
        if (width == 128)
            return two ? wg::launch<T, 128, 2>(q, k, v, dout, lse, delta, slopes, dq, bh, t, d,
                                               n_heads, scale, causal, stream)
                       : wg::launch<T, 128, 1>(q, k, v, dout, lse, delta, slopes, dq, bh, t, d,
                                               n_heads, scale, causal, stream);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout, dq: (bh, t, d) contiguous in `dtype`, d a multiple of 8 up to
// 128; lse, delta: (bh, t) f32;
// slopes: (n_heads,) f32 or null, head of row block i is i % n_heads.
// Returns cudaGetLastError().
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* slopes, void* dq,
                            int bh, int t, int d, int n_heads, float scale, int causal,
                            int dtype, void* stream) {
    if (bh <= 0 || t <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DS_F32:
            return (int)dispatch_d<float>(q, k, v, dout, lse, delta, slopes, dq, bh, t, d,
                                          n_heads, scale, causal, s);
        case DS_F16:
            return (int)dispatch_d<__half>(q, k, v, dout, lse, delta, slopes, dq, bh, t, d,
                                           n_heads, scale, causal, s);
        case DS_BF16:
            return (int)dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, slopes, dq, bh,
                                                  t, d, n_heads, scale, causal, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
