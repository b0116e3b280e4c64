// Block-sparse attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/block_sparse.py:_fwd_kernel
// (launched by the pallas_call in _bs_fwd): attention of q/k/v (b*h, t, d)
// over only the active blocks of a (H, nb, nb) block layout. One thread
// block owns one (b*h, q-block) and walks its row of the forward table
// (idx (H, nb, max_n), cnt (H, nb), int32, read from device memory; head
// i % n_heads) in ascending k-block order with an online softmax. Under
// `causal` the triangle applies inside the blocks. Returns o and the f32
// logsumexp that the backward kernels reuse.
//
// Masking is the TPU kernel's exactly: the running max starts at -1e30 and a
// masked score is the finite -1e30, so a row whose walked entries are all
// masked (its active blocks lie past the diagonal) gets p = exp(0) = 1 on
// each of them, the mean of those V rows, and an lse of about -1e30; a row
// with no active block gets o = 0 and lse = -1e30. Blocks past the diagonal
// are walked like any other: skipping them would change such rows.
//
// What bounds it on this card: per walked (row, col) pair 4*d operations (s =
// q.k, o += p.v) on 8*t*d bytes per (batch, head) plus the table. The
// training main path's layout (Fixed, block 16, 4 local blocks, 1 global, 4
// patterns, t 1024) walks 15.6 % of the blocks, 156,160 causal pairs a head:
// about 76 operations a byte, far below the ~295 bf16 operations a byte where
// the tensor cores become the limit, so device-memory bytes bound it. This
// first version does its products on the CUDA cores in f32 (inputs are widened
// as they are staged into shared memory): each walked k-block costs a 16-row
// tile a load of its k and v rows from L2 or memory, so it runs far from that
// bound. wgmma over several q-blocks that share k-blocks, TMA and warp
// specialisation are later work. What the design keeps: the score tile never
// reaches device memory, and the work follows the layout's density, not t^2.
//
// Numerics follow the TPU kernel: scores in f32, f32 p (not rounded to the
// input dtype) in the product with v, f32 accumulator, a row with l == 0
// divided by 1, o rounded to the input dtype once.

#include "block_sparse_core.cuh"

namespace {

using block_sparse::Geom;
using block_sparse::stage;

template <int B, int D>
constexpr size_t smem_bytes() {
    using G = Geom<B, D>;
    // q tile [B][DP], k tile [SUB][DP], v tile [SUB][D], p tile [B][SP]
    return sizeof(float) * (size_t)(B * G::DP + G::SUB * G::DP + G::SUB * D + B * G::SP);
}

template <typename T, int B, int D>
__global__ void __launch_bounds__(Geom<B, D>::NT)
block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ idx,
                        const int* __restrict__ cnt, T* __restrict__ o,
                        float* __restrict__ lse, int t, int n_heads, int max_n, float scale,
                        int causal) {
    using G = Geom<B, D>;
    constexpr int NT = G::NT, SUB = G::SUB, CJ = G::CJ, DC = G::DC, DP = G::DP, SP = G::SP;
    extern __shared__ float smem[];
    float* qs = smem;                   // [B][DP]
    float* ks = qs + B * DP;            // [SUB][DP]
    float* vs = ks + SUB * DP;          // [SUB][D]
    float* ps = vs + SUB * D;           // [B][SP]

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int qb = blockIdx.x;
    const int bh = blockIdx.y;
    const int nb = t / B;
    const int head = bh % n_heads;
    const int q0 = qb * B;
    const size_t base = (size_t)bh * t * D;
    const int* walk = idx + ((size_t)head * nb + qb) * max_n;
    const int nnz = cnt[head * nb + qb];

    stage<T, D, B, DP, NT>(qs, q + base + (size_t)q0 * D, tid);

    float acc[4][DC];
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = DS_NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    }

    for (int n = 0; n < nnz; ++n) {
        const int kb = walk[n];
        for (int sub = 0; sub < B; sub += SUB) {
            const int k0 = kb * B + sub;
            __syncthreads();            // q is staged; the previous tile's k/v/p reads are done
            stage<T, D, SUB, DP, NT>(ks, k + base + (size_t)k0 * D, tid);
            stage<T, D, SUB, D, NT>(vs, v + base + (size_t)k0 * D, tid);
            __syncthreads();

            float s[4][CJ];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
            for (int c = 0; c < D; ++c) {
                float qv[4], kv[CJ];
#pragma unroll
                for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * DP + c];
#pragma unroll
                for (int j = 0; j < CJ; ++j) kv[j] = ks[(tx + 16 * j) * DP + c];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            }

#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = ty * 4 + i;
                const int row = q0 + r;
                float mx = DS_NEG_INF;
#pragma unroll
                for (int j = 0; j < CJ; ++j) {
                    const int col = k0 + tx + 16 * j;
                    const float x = (causal && col > row) ? DS_NEG_INF : s[i][j] * scale;
                    s[i][j] = x;
                    mx = fmaxf(mx, x);
                }
                mx = warp_max16(mx);
                const float m_new = fmaxf(m[i], mx);
                const float alpha = expf(m[i] - m_new);
                float psum = 0.f;
#pragma unroll
                for (int j = 0; j < CJ; ++j) {
                    const float p = expf(s[i][j] - m_new);
                    psum += p;
                    ps[r * SP + tx + 16 * j] = p;
                }
                l[i] = l[i] * alpha + psum;     // this thread's share of the row sum
                m[i] = m_new;
#pragma unroll
                for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
            }
            __syncthreads();

#pragma unroll 4
            for (int c = 0; c < SUB; ++c) {
                float vv[DC];
#pragma unroll
                for (int cc = 0; cc < DC; ++cc) vv[cc] = vs[c * D + tx + 16 * cc];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p = ps[(ty * 4 + i) * SP + c];
#pragma unroll
                    for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float lt = warp_sum16(l[i]);
        const float l_safe = lt > 0.f ? lt : 1.f;
        const int row = q0 + ty * 4 + i;
        const size_t off = base + (size_t)row * D;
#pragma unroll
        for (int c = 0; c < DC; ++c) o[off + tx + 16 * c] = from_f32<T>(acc[i][c] / l_safe);
        if (tx == 0) lse[(size_t)bh * t + row] = lt > 0.f ? m[i] + logf(l_safe) : DS_NEG_INF;
    }
}

struct Fwd {
    template <typename T, int B, int D>
    static cudaError_t run(const void* q, const void* k, const void* v, const void* idx,
                           const void* cnt, void* o, void* lse, int bh, int t, int n_heads,
                           int max_n, float scale, int causal, cudaStream_t stream) {
        return block_sparse::launch(
            block_sparse_fwd_kernel<T, B, D>, smem_bytes<B, D>(), t / B, bh, Geom<B, D>::NT,
            stream, static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const int*>(idx),
            static_cast<const int*>(cnt), static_cast<T*>(o), static_cast<float*>(lse), t,
            n_heads, max_n, scale, causal);
    }
};

}  // namespace

// q, k, v, o: (bh, t, d) contiguous in `dtype`; idx: (n_heads, t / block, max_n)
// and cnt: (n_heads, t / block) int32, the forward table; lse: (bh, t) f32.
// The head of row block i is i % n_heads. Returns cudaGetLastError().
extern "C" int block_sparse_fwd(const void* q, const void* k, const void* v, const void* idx,
                                const void* cnt, void* o, void* lse, int bh, int t, int d,
                                int n_heads, int block, int max_n, float scale, int causal,
                                int dtype, void* stream) {
    if (block_sparse::bad_args(bh, t, n_heads, block, max_n)) return (int)cudaErrorInvalidValue;
    return (int)block_sparse::dispatch<Fwd>(dtype, block, d, q, k, v, idx, cnt, o, lse, bh, t,
                                            n_heads, max_n, scale, causal,
                                            static_cast<cudaStream_t>(stream));
}
