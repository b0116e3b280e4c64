// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/flash.py:_fwd_kernel
// (launched by the pallas_call in _flash_fwd): causal or full attention over
// q/k/v (b*h, t, d) with an online softmax, an optional ALiBi bias
// slope[h] * (col - row), and the f32 logsumexp that the backward reuses. The
// (t x t) score matrix never reaches device memory.
//
// What bounds it on this card: causal attention does about 2*t*t*d operations
// on 8*t*d bytes (bf16 q, k, v in, o out) per (batch, head), t/4 operations a
// byte. At the serving prefill's t = 512 that is 128, below the ~295 bf16
// operations a byte where the H100's tensor cores become the limit, so
// device-memory bytes bound it; from t of about 1200 up, the operations do.
// This first version does its products on the CUDA cores in f32 (bf16 inputs
// are widened as they are staged into shared memory), so it runs far from
// either bound; wgmma, TMA and warp specialisation are later work. What the
// design does keep: each block stages one q tile and streams K/V tiles
// through shared memory, so the score matrix stays on chip, and under
// `causal` a block stops at the diagonal tile, halving the work.
//
// Layout of one block (256 threads, one 64-row q tile of one (batch, head)):
// thread (ty, tx) = (tid / 16, tid % 16) owns rows 4*ty .. 4*ty+3 of the tile;
// of each 64-column score tile it computes columns tx + 16*j, and of the
// output columns tx + 16*c. The 16 threads of a row group sit in one half
// warp, so row maxima and sums are shuffles. Numerics follow the TPU kernel:
// scores in f32, masked entries set to -1e30, P rounded to the input dtype
// before the PV product, f32 accumulator, a row with l == 0 divided by 1.
// Rows and columns past t (a ragged last tile) are masked here, so any t works.

#include "common.cuh"

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // k/v rows per tile
constexpr int NTHREADS = 256;
constexpr int BKP = BK + 1;     // padded row stride of the P tile

template <int D>
constexpr size_t smem_bytes() {
    // q tile [BQ][D+1], k tile [BK][D+1], v tile [BK][D], P tile [BQ][BK+1]
    return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * BKP);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ slopes, T* __restrict__ o,
                 float* __restrict__ lse, int t, int n_heads, float scale, int causal) {
    extern __shared__ float smem[];
    constexpr int DP = D + 1;
    constexpr int DC = D / 16;          // output columns per thread
    float* qs = smem;                   // [BQ][DP]
    float* ks = qs + BQ * DP;           // [BK][DP]
    float* vs = ks + BK * DP;           // [BK][D]
    float* ps = vs + BK * D;            // [BQ][BKP]

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int q0 = blockIdx.x * BQ;
    const int bh = blockIdx.y;
    const size_t base = (size_t)bh * t * D;
    const bool use_alibi = slopes != nullptr;
    const float slope = use_alibi ? slopes[bh % n_heads] : 0.f;

    // tiles move as 16-byte vectors; K/V of the next tile are fetched into
    // registers while the current tile computes
    constexpr int VEC = vec_elems<T>();
    constexpr int ROW_VECS = D / VEC;
    constexpr int PER_THREAD = BK * ROW_VECS / NTHREADS;
    static_assert(BK * ROW_VECS % NTHREADS == 0 && BQ == BK, "tiles must split evenly");
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const int vi = tid + i * NTHREADS;
        const int r = vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
        const int row = q0 + r;
        const uint4 raw = row < t ? load16(q + base + (size_t)row * D + c)
                                  : make_uint4(0u, 0u, 0u, 0u);
        store16_f32<T>(qs + r * DP + c, raw);
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
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = DS_NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    }

    int nk = (t + BK - 1) / BK;
    if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);   // stop at the diagonal tile

    fetch(0);
    for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                // the previous tile's k/v/P reads are done
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            const int vi = tid + i * NTHREADS;
            const int r = vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
            store16_f32<T>(ks + r * DP + c, kreg[i]);
            store16_f32<T>(vs + r * D + c, vreg[i]);
        }
        if (kt + 1 < nk) fetch(k0 + BK);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * DP + c];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * DP + c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            const int row = q0 + r;
            float mx = DS_NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = k0 + tx + 16 * j;
                float x = s[i][j] * scale;
                if (use_alibi) x += slope * (float)(col - row);
                const bool valid = col < t && (!causal || col <= row);
                x = valid ? x : DS_NEG_INF;
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
            mx = warp_max16(mx);
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                psum += p;
                ps[r * BKP + tx + 16 * j] = round_to<T>(p);
            }
            l[i] = l[i] * alpha + psum;     // this thread's share of the row sum
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            float vv[DC];
#pragma unroll
            for (int cc = 0; cc < DC; ++cc) vv[cc] = vs[c * D + tx + 16 * cc];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float p = ps[(ty * 4 + i) * BKP + c];
#pragma unroll
                for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float lt = warp_sum16(l[i]);
        const float l_safe = lt > 0.f ? lt : 1.f;
        const int row = q0 + ty * 4 + i;
        if (row < t) {
            const size_t off = base + (size_t)row * D;
#pragma unroll
            for (int c = 0; c < DC; ++c) o[off + tx + 16 * c] = from_f32<T>(acc[i][c] / l_safe);
            if (tx == 0) lse[(size_t)bh * t + row] = m[i] + logf(l_safe);
        }
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* slopes, void* o,
                   void* lse, int bh, int t, int n_heads, float scale, int causal,
                   cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((t + BQ - 1) / BQ, bh);
    flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(slopes), static_cast<T*>(o), static_cast<float*>(lse), t,
        n_heads, scale, causal);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* slopes, void* o,
                       void* lse, int bh, int t, int d, int n_heads, float scale, int causal,
                       cudaStream_t stream) {
    if (d == 64)
        return launch<T, 64>(q, k, v, slopes, o, lse, bh, t, n_heads, scale, causal, stream);
    if (d == 128)
        return launch<T, 128>(q, k, v, slopes, o, lse, bh, t, n_heads, scale, causal, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: (bh, t, d) contiguous in `dtype`; slopes: (n_heads,) f32 or null,
// head of row block i is i % n_heads; lse: (bh, t) f32. Returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* slopes, void* o,
                         void* lse, int bh, int t, int d, int n_heads, float scale, int causal,
                         int dtype, void* stream) {
    if (bh <= 0 || t <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (dtype) {
        case DS_F32:
            err = dispatch_d<float>(q, k, v, slopes, o, lse, bh, t, d, n_heads, scale, causal, s);
            break;
        case DS_F16:
            err = dispatch_d<__half>(q, k, v, slopes, o, lse, bh, t, d, n_heads, scale, causal, s);
            break;
        case DS_BF16:
            err = dispatch_d<__nv_bfloat16>(q, k, v, slopes, o, lse, bh, t, d, n_heads, scale,
                                            causal, s);
            break;
        default:
            err = cudaErrorInvalidValue;
    }
    return (int)err;
}
