// Decode attention against a head-major KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/decode.py:_decode_kernel
// (launched by the pallas_call in decode_attention): one decode step of
// q (b, h, d) against k/v caches (b, h_kv, T, d), each sequence masked by its
// cache_len, the g = h / h_kv query heads of a kv group sharing one pass over
// that group's cache rows. All arithmetic is f32; the output is in q's dtype.
//
// What bounds it on this card: every cache byte read feeds 2*g multiply-adds,
// a few operations a byte against the H100's ~295, so device-memory bytes
// bound it. The design reads only what the step needs: a block reads the
// first cdiv(cache_len, 64) tiles of its (sequence, kv head), never the whole
// capacity T, and reads them once for all g query heads of the group.
//
// Layout: one block of 128 threads per (sequence, kv head). Each 64-row K/V
// tile is read with 16-byte loads into registers while the previous tile
// computes, then staged into shared memory as f32; the g x 64 scores are computed
// one per thread; one warp per query head updates that head's running max
// and sum; the g x d accumulator lives in shared memory. At batch 4 and 12
// kv heads that is 48 blocks on 132 SMs: splitting the sequence across blocks
// is later work.

#include "common.cuh"

namespace {

constexpr int BK = 64;          // cache rows per tile (two per lane in the softmax)
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;

template <int D>
size_t smem_bytes(int g) {
    // q [g][D], k tile [BK][D+1], v tile [BK][D], scores [g][BK], acc [g][D],
    // running max, sum and rescale factor [3][g]
    return sizeof(float) *
           ((size_t)g * D + BK * (D + 1) + BK * D + (size_t)g * BK + (size_t)g * D + 3 * (size_t)g);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ lens, T* __restrict__ out, int hk, int g, int cap,
              float scale) {
    extern __shared__ float smem[];
    constexpr int DP = D + 1;
    float* qs = smem;                   // [g][D]
    float* ks = qs + g * D;             // [BK][DP]
    float* vs = ks + BK * DP;           // [BK][D]
    float* ss = vs + BK * D;            // [g][BK]
    float* acc = ss + g * BK;           // [g][D]
    float* m = acc + g * D;             // [g]
    float* l = m + g;                   // [g]
    float* alpha = l + g;               // [g]

    const int bi = blockIdx.x;
    const int kh = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int len = min(max(lens[bi], 0), cap);
    const size_t qoff = ((size_t)bi * hk + kh) * g * D;        // heads kh*g .. kh*g+g-1
    const size_t coff = ((size_t)bi * hk + kh) * (size_t)cap * D;

    for (int e = tid; e < g * D; e += NTHREADS) {
        qs[e] = to_f32(q[qoff + e]);
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
            const size_t idx = coff + (size_t)row * D + (vi % ROW_VECS) * VEC;
            const bool ok = row < cap;
            kreg[i] = ok ? load16(kc + idx) : make_uint4(0u, 0u, 0u, 0u);
            vreg[i] = ok ? load16(vc + idx) : make_uint4(0u, 0u, 0u, 0u);
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
        out[qoff + e] = from_f32<T>(acc[e] / (lj > 0.f ? lj : 1.f));
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* lens, void* out,
                   int b, int hk, int g, int cap, float scale, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>(g);
    cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(b, hk);
    decode_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
        static_cast<const int*>(lens), static_cast<T*>(out), hk, g, cap, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* kc, const void* vc, const void* lens, void* out,
                       int b, int hk, int g, int cap, int d, float scale, cudaStream_t stream) {
    if (d == 64) return launch<T, 64>(q, kc, vc, lens, out, b, hk, g, cap, scale, stream);
    if (d == 128) return launch<T, 128>(q, kc, vc, lens, out, b, hk, g, cap, scale, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (b, hk*g, d); k_cache, v_cache: (b, hk, cap, d), all contiguous in
// `dtype`; lens: (b,) int32 valid rows per sequence. Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* kc, const void* vc, const void* lens,
                                void* out, int b, int hk, int g, int cap, int d, float scale,
                                int dtype, void* stream) {
    if (b <= 0 || hk <= 0 || g <= 0 || cap <= 0 || hk > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (dtype) {
        case DS_F32:
            err = dispatch_d<float>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, s);
            break;
        case DS_F16:
            err = dispatch_d<__half>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, s);
            break;
        case DS_BF16:
            err = dispatch_d<__nv_bfloat16>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, s);
            break;
        default:
            err = cudaErrorInvalidValue;
    }
    return (int)err;
}
