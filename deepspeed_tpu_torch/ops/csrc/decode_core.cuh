// The body shared by the two decode kernels (decode_attention.cu over a dense
// head-major cache, paged_decode_attention.cu over a page pool): one block of
// NTHREADS threads computes one decode step of the g query heads of one kv
// head against the first `len` rows of that kv head's cache. Where row r of
// the cache lives is the caller's: `rows.offset(r)` is the element offset of
// its first value in k and v, and `rows.readable(r)` says whether r has
// storage at all (a row past `len` may still be loaded and is then masked).
//
// Each 64-row K/V tile is read with 16-byte loads into registers while the
// previous tile computes, then staged into shared memory as f32; the g x 64
// scores are computed one per thread; one warp per query head updates that
// head's running max and sum; the g x d accumulator lives in shared memory.
// All arithmetic is f32; the output is rounded to T once, at the end. A
// sequence with len 0 writes zeros.
#pragma once

#include "common.cuh"

namespace decode_core {

constexpr int BK = 64;          // cache rows per tile (two per lane in the softmax)
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

// shared memory of decode_block: q [g][D], k tile [BK][D+1], v tile [BK][D],
// scores [g][BK], acc [g][D], running max, sum and rescale factor [3][g]
template <int D>
__host__ __device__ constexpr size_t smem_floats(int g) {
    return (size_t)g * D + BK * (D + 1) + BK * D + (size_t)g * BK + (size_t)g * D + 3 * (size_t)g;
}

// q, out: the g x D query rows and output rows of this block; k, v: the cache
// base that rows.offset() indexes; smem: smem_floats<D>(g) floats.
template <typename T, int D, typename Rows>
__device__ __forceinline__ void decode_block(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, T* __restrict__ out,
                                             int len, int g, float scale, const Rows& rows,
                                             float* smem) {
    constexpr int DP = D + 1;
    float* qs = smem;                   // [g][D]
    float* ks = qs + g * D;             // [BK][DP]
    float* vs = ks + BK * DP;           // [BK][D]
    float* ss = vs + BK * D;            // [g][BK]
    float* acc = ss + g * BK;           // [g][D]
    float* m = acc + g * D;             // [g]
    float* l = m + g;                   // [g]
    float* alpha = l + g;               // [g]

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    for (int e = tid; e < g * D; e += NTHREADS) {
        qs[e] = to_f32(q[e]);
        acc[e] = 0.f;
    }
    for (int j = tid; j < g; j += NTHREADS) {
        m[j] = DS_NEG_INF;
        l[j] = 0.f;
    }

    // each thread fetches PER_THREAD 16-byte vectors of K and of V per tile into
    // registers; the next tile's fetch is in flight while this tile computes
    constexpr int VEC = vec_elems<T>();
    constexpr int ROW_VECS = D / VEC;
    constexpr int PER_THREAD = BK * ROW_VECS / NTHREADS;
    static_assert(BK * ROW_VECS % NTHREADS == 0, "tile must split evenly over threads");
    uint4 kreg[PER_THREAD], vreg[PER_THREAD];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            const int vi = tid + i * NTHREADS;
            const int row = k0 + vi / ROW_VECS;
            const bool ok = rows.readable(row);
            const size_t idx = ok ? rows.offset(row) + (vi % ROW_VECS) * VEC : 0;
            kreg[i] = ok ? load16(k + idx) : make_uint4(0u, 0u, 0u, 0u);
            vreg[i] = ok ? load16(v + idx) : make_uint4(0u, 0u, 0u, 0u);
        }
    };

    const int nt = (len + BK - 1) / BK;  // only the tiles that hold valid rows
    if (nt > 0) fetch(0);
    for (int kt = 0; kt < nt; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                // previous tile fully consumed; q/acc/m/l set
#pragma unroll
        for (int i = 0; i < PER_THREAD; ++i) {
            const int vi = tid + i * NTHREADS;
            const int r = vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
            store16_f32<T>(ks + r * DP + c, kreg[i]);
            store16_f32<T>(vs + r * D + c, vreg[i]);
        }
        if (kt + 1 < nt) fetch(k0 + BK);
        __syncthreads();

        for (int e = tid; e < g * BK; e += NTHREADS) {
            const int j = e / BK, c = e % BK;
            const float* qj = qs + j * D;
            const float* kr = ks + c * DP;
            float dot = 0.f;
#pragma unroll 16
            for (int d = 0; d < D; ++d) dot = fmaf(qj[d], kr[d], dot);
            ss[e] = (k0 + c < len) ? dot * scale : DS_NEG_INF;
        }
        __syncthreads();

        for (int j = warp; j < g; j += NWARPS) {
            float* sj = ss + j * BK;
            const float x0 = sj[lane], x1 = sj[lane + 32];
            const float mx = warp_max32(fmaxf(x0, x1));
            const float m_old = m[j];
            const float m_new = fmaxf(m_old, mx);
            const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
            sj[lane] = p0;
            sj[lane + 32] = p1;
            const float psum = warp_sum32(p0 + p1);
            if (lane == 0) {
                const float a = expf(m_old - m_new);
                alpha[j] = a;
                l[j] = l[j] * a + psum;
                m[j] = m_new;
            }
        }
        __syncthreads();

        for (int e = tid; e < g * D; e += NTHREADS) {
            const int j = e / D, c = e % D;
            const float* pj = ss + j * BK;
            float a = acc[e] * alpha[j];
#pragma unroll 16
            for (int r = 0; r < BK; ++r) a = fmaf(pj[r], vs[r * D + c], a);
            acc[e] = a;
        }
    }
    __syncthreads();

    for (int e = tid; e < g * D; e += NTHREADS) {
        const float lj = l[e / D];
        out[e] = from_f32<T>(acc[e] / (lj > 0.f ? lj : 1.f));
    }
}

}  // namespace decode_core
