// Flash-attention backward, dq, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/flash.py:_bwd_dq_kernel
// (launched by the first pallas_call in _flash_bwd): dq of causal or full
// attention over q/k/v/do (b*h, t, d), recomputing the probabilities tile by
// tile from the forward's f32 logsumexp, so the (t x t) matrices never reach
// device memory. The TPU grid walks kv blocks as its sequential last axis and
// carries dq in VMEM scratch between grid steps; here one block owns a 64-row
// q tile and walks the kv tiles in a loop, with dq in registers.
//
// What bounds it on this card: per causal (row, col) pair it does 6*d
// operations (s = q.k, dp = do.v, dq += ds.k) on 10*t*d bytes per (batch,
// head) (bf16 q, k, v, do in, dq out, plus f32 lse and delta), about 0.3*t
// operations a byte: at the training main path's t = 1024 that is ~300, at the
// ~295 bf16 operations a byte where the H100's tensor cores become the limit.
// This first version does its products on the CUDA cores in f32 (inputs are
// widened as they are staged into shared memory), so it runs far from either
// bound; wgmma, TMA and warp specialisation are later work. What the design
// does keep: the score, dp and ds tiles stay on chip, a causal block stops at
// the diagonal tile, and the next k/v tile is fetched into registers while the
// current one computes.
//
// Numerics follow the TPU kernel and the forward (csrc/flash_fwd.cu): s is
// summed over d in the same order, scaled, biased (ALiBi slope*(col - row)) and
// masked to -1e30 as in the forward, so p = exp(s - lse) is the forward's
// probability; ds = p*(dp - delta)*scale is rounded to the input dtype before
// the product with k; dq accumulates in f32 and is written once in q's dtype.
// Rows and columns past t (a ragged last tile) are masked, so any t works.
//
// Layout of one block (256 threads, one 64-row q tile of one (batch, head)):
// thread (ty, tx) = (tid / 16, tid % 16) owns rows 4*ty .. 4*ty+3; of each
// 64-column score tile it computes columns tx + 16*j, and of dq the columns
// tx + 16*c. Shared memory holds q, do, k, v as f32 tiles with padded rows and
// the f32 ds tile: 149 KB at d = 128, so it is dynamic shared memory.

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
                    T* __restrict__ dq, int t, int n_heads, float scale, int causal) {
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
    const size_t base = (size_t)bh * t * D;
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
        const bool ok = row < t;
        const size_t idx = base + (size_t)row * D + c;
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
            const int row = k0 + vi / ROW_VECS;
            const size_t idx = base + (size_t)row * D + (vi % ROW_VECS) * VEC;
            const bool ok = row < t;
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
            const size_t off = base + (size_t)row * D;
#pragma unroll
            for (int c = 0; c < DC; ++c) dq[off + tx + 16 * c] = from_f32<T>(acc[i][c]);
        }
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* slopes, void* dq, int bh,
                   int t, int n_heads, float scale, int causal, cudaStream_t stream) {
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
        static_cast<T*>(dq), t, n_heads, scale, causal);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* slopes, void* dq,
                       int bh, int t, int d, int n_heads, float scale, int causal,
                       cudaStream_t stream) {
    if (d == 64)
        return launch<T, 64>(q, k, v, dout, lse, delta, slopes, dq, bh, t, n_heads, scale,
                             causal, stream);
    if (d == 128)
        return launch<T, 128>(q, k, v, dout, lse, delta, slopes, dq, bh, t, n_heads, scale,
                              causal, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout, dq: (bh, t, d) contiguous in `dtype`; lse, delta: (bh, t) f32;
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
