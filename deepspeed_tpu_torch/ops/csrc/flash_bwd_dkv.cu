// Flash-attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/flash.py:_bwd_dkv_kernel
// (launched by the second pallas_call in _flash_bwd): dk and dv of causal or
// full attention over q/k/v/do (b*h, t, d), recomputing the probabilities tile
// by tile from the forward's f32 logsumexp. The TPU grid walks q blocks as its
// sequential last axis and carries dk/dv in VMEM scratch; here one block owns a
// 64-row kv tile and walks the q tiles in a loop, from the first one that meets
// the causal triangle (_causal_q_lo), with dk and dv in registers. dq is the
// other kernel's (csrc/flash_bwd_dq.cu): two kernels, as in the JAX package, so
// no block adds into another's output, no atomics are needed and the
// gradients are the same on every run.
//
// What bounds it on this card: per causal (row, col) pair it does 8*d
// operations (s = q.k, dp = do.v, dv += p.do, dk += ds.q) on 12*t*d bytes per
// (batch, head) (bf16 q, k, v, do in, dk and dv out, plus f32 lse and delta),
// about t/3 operations a byte: ~340 at the training main path's t = 1024,
// just above the ~295 bf16 operations a byte where the H100's tensor cores
// become the limit. This first version does its products on the CUDA cores in
// f32, so it runs far from either bound; wgmma, TMA and warp specialisation
// are later work. What the design does keep: the transposed score, p and ds
// tiles stay on chip, a causal block skips the q tiles above the diagonal, and
// the next q/do tile is fetched into registers while the current one computes.
//
// Numerics follow the TPU kernel and the forward (csrc/flash_fwd.cu): s is
// summed over d in the forward's order, scaled, biased and masked to -1e30 as
// there, so p = exp(s - lse) is the forward's probability; p is rounded to do's
// dtype before the product with do, ds = p*(dp - delta)*scale to q's dtype
// before the product with q; dk and dv accumulate in f32. Rows and columns past
// t (a ragged last tile) are masked, so any t works.
//
// Layout of one block (256 threads, one 64-row kv tile of one (batch, head)):
// thread (ty, tx) = (tid / 16, tid % 16) owns kv rows 4*ty .. 4*ty+3; of each
// transposed 64-column score tile it computes q columns tx + 16*j, and of dk
// and dv the columns tx + 16*c. Shared memory holds k, v, q, do as f32 tiles
// with padded rows, the f32 p and ds tiles and the tile's lse and delta: 166 KB
// at d = 128, so it is dynamic shared memory.

#include "common.cuh"

namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // k/v rows per block
constexpr int NTHREADS = 256;
constexpr int BQP = BQ + 1;     // padded row stride of the p and ds tiles

template <int D>
constexpr size_t smem_bytes() {
    // k, v, q, do tiles [64][D+1], p and ds tiles [BK][BQ+1], lse and delta [BQ]
    return sizeof(float) * (size_t)(4 * 64 * (D + 1) + 2 * BK * BQP + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ slopes,
                     T* __restrict__ dk, T* __restrict__ dv, int t, int n_heads, float scale,
                     int causal) {
    extern __shared__ float smem[];
    constexpr int DP = D + 1;
    constexpr int DC = D / 16;          // dk/dv columns per thread
    float* ks = smem;                   // [BK][DP]
    float* vs = ks + BK * DP;           // [BK][DP]
    float* qs = vs + BK * DP;           // [BQ][DP]
    float* dos = qs + BQ * DP;          // [BQ][DP]
    float* ps = dos + BQ * DP;          // [BK][BQP]
    float* dss = ps + BK * BQP;         // [BK][BQP]
    float* lse_s = dss + BK * BQP;      // [BQ]
    float* delta_s = lse_s + BQ;        // [BQ]

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int k0 = blockIdx.x * BK;
    const int bh = blockIdx.y;
    const size_t base = (size_t)bh * t * D;
    const size_t row_base = (size_t)bh * t;
    const bool use_alibi = slopes != nullptr;
    const float slope = use_alibi ? slopes[bh % n_heads] : 0.f;

    constexpr int VEC = vec_elems<T>();
    constexpr int ROW_VECS = D / VEC;
    constexpr int PER_THREAD = BQ * ROW_VECS / NTHREADS;
    static_assert(BQ * ROW_VECS % NTHREADS == 0 && BQ == BK, "tiles must split evenly");
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const int vi = tid + i * NTHREADS;
        const int r = vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
        const int row = k0 + r;
        const bool ok = row < t;
        const size_t idx = base + (size_t)row * D + c;
        store16_f32<T>(ks + r * DP + c, ok ? load16(k + idx) : make_uint4(0u, 0u, 0u, 0u));
        store16_f32<T>(vs + r * DP + c, ok ? load16(v + idx) : make_uint4(0u, 0u, 0u, 0u));
    }

    // q, do, lse and delta of the next q tile are fetched into registers while
    // the current tile computes; threads 0..BQ-1 carry one row's lse and delta
    uint4 qreg[PER_THREAD], doreg[PER_THREAD];
    float lse_reg = 0.f, delta_reg = 0.f;
    auto fetch = [&](int q0) {
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            const int vi = tid + i * NTHREADS;
            const int row = q0 + vi / ROW_VECS;
            const size_t idx = base + (size_t)row * D + (vi % ROW_VECS) * VEC;
            const bool ok = row < t;
            qreg[i] = ok ? load16(q + idx) : make_uint4(0u, 0u, 0u, 0u);
            doreg[i] = ok ? load16(dout + idx) : make_uint4(0u, 0u, 0u, 0u);
        }
        if (tid < BQ) {
            const bool ok = q0 + tid < t;
            lse_reg = ok ? lse[row_base + q0 + tid] : 0.f;
            delta_reg = ok ? delta[row_base + q0 + tid] : 0.f;
        }
    };

    float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

    const int nq = (t + BQ - 1) / BQ;
    const int q_lo = causal ? k0 / BQ : 0;      // first q tile meeting the triangle

    if (q_lo < nq) fetch(q_lo * BQ);
    for (int qt = q_lo; qt < nq; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();                // the previous tile's q/do/p/ds reads are done
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            const int vi = tid + i * NTHREADS;
            const int r = vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
            store16_f32<T>(qs + r * DP + c, qreg[i]);
            store16_f32<T>(dos + r * DP + c, doreg[i]);
        }
        if (tid < BQ) {
            lse_s[tid] = lse_reg;
            delta_s[tid] = delta_reg;
        }
        if (qt + 1 < nq) fetch(q0 + BQ);
        __syncthreads();

        // s^T = k q^T and dp^T = v do^T, summed over d in the forward's order
        float s[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) {
            float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                kv[i] = ks[(ty * 4 + i) * DP + c];
                vv[i] = vs[(ty * 4 + i) * DP + c];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                qv[j] = qs[(tx + 16 * j) * DP + c];
                dov[j] = dos[(tx + 16 * j) * DP + c];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
                    dp[i][j] = fmaf(dov[j], vv[i], dp[i][j]);
                }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            const int col = k0 + r;             // the key's position
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int qj = tx + 16 * j;
                const int row = q0 + qj;        // the query's position
                float x = s[i][j] * scale;
                if (use_alibi) x += slope * (float)(col - row);
                const bool valid = row < t && col < t && (!causal || col <= row);
                const float p = valid ? expf(x - lse_s[qj]) : 0.f;
                ps[r * BQP + qj] = round_to<T>(p);
                dss[r * BQP + qj] = round_to<T>(p * (dp[i][j] - delta_s[qj]) * scale);
            }
        }
        __syncthreads();

        // dv += p^T do, dk += ds^T q
#pragma unroll 4
        for (int c = 0; c < BQ; ++c) {
            float dov[DC], qv[DC];
#pragma unroll
            for (int cc = 0; cc < DC; ++cc) {
                dov[cc] = dos[c * DP + tx + 16 * cc];
                qv[cc] = qs[c * DP + tx + 16 * cc];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float p = ps[(ty * 4 + i) * BQP + c];
                const float ds = dss[(ty * 4 + i) * BQP + c];
#pragma unroll
                for (int cc = 0; cc < DC; ++cc) {
                    dv_acc[i][cc] = fmaf(p, dov[cc], dv_acc[i][cc]);
                    dk_acc[i][cc] = fmaf(ds, qv[cc], dk_acc[i][cc]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = k0 + ty * 4 + i;
        if (row < t) {
            const size_t off = base + (size_t)row * D;
#pragma unroll
            for (int c = 0; c < DC; ++c) {
                dk[off + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
                dv[off + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
            }
        }
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* slopes, void* dk, void* dv,
                   int bh, int t, int n_heads, float scale, int causal, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((t + BK - 1) / BK, bh);
    flash_bwd_dkv_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const float*>(slopes),
        static_cast<T*>(dk), static_cast<T*>(dv), t, n_heads, scale, causal);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* slopes, void* dk,
                       void* dv, int bh, int t, int d, int n_heads, float scale, int causal,
                       cudaStream_t stream) {
    if (d == 64)
        return launch<T, 64>(q, k, v, dout, lse, delta, slopes, dk, dv, bh, t, n_heads, scale,
                             causal, stream);
    if (d == 128)
        return launch<T, 128>(q, k, v, dout, lse, delta, slopes, dk, dv, bh, t, n_heads,
                              scale, causal, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout, dk, dv: (bh, t, d) contiguous in `dtype`; lse, delta: (bh, t)
// f32; slopes: (n_heads,) f32 or null, head of row block i is i % n_heads.
// Returns cudaGetLastError().
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* slopes, void* dk,
                             void* dv, int bh, int t, int d, int n_heads, float scale,
                             int causal, int dtype, void* stream) {
    if (bh <= 0 || t <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DS_F32:
            return (int)dispatch_d<float>(q, k, v, dout, lse, delta, slopes, dk, dv, bh, t, d,
                                          n_heads, scale, causal, s);
        case DS_F16:
            return (int)dispatch_d<__half>(q, k, v, dout, lse, delta, slopes, dk, dv, bh, t,
                                           d, n_heads, scale, causal, s);
        case DS_BF16:
            return (int)dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, slopes, dk, dv,
                                                  bh, t, d, n_heads, scale, causal, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
