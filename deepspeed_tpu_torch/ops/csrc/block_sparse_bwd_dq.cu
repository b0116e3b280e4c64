// Block-sparse attention backward, dq, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/block_sparse.py:_bwd_dq_kernel
// (launched by the first pallas_call in _bs_bwd): dq of block-sparse
// attention over q/k/v/do (b*h, t, d). One thread block owns one (b*h,
// q-block), walks the same forward table as csrc/block_sparse_fwd.cu (read
// from device memory; head i % n_heads) and recomputes the probabilities
// tile by tile from the forward's f32 logsumexp, so the score, dp and ds
// tiles never reach device memory; dq stays in registers and is written once.
// delta = rowsum(do * o) comes in from outside the kernel, as in the JAX
// package.
//
// Masking is the forward's: a masked score is -1e30 and p = exp(s - lse), so
// on a row with a valid key a masked entry gets p = 0, and on a row whose
// walked entries are all masked (lse about -1e30) each gets p = 1, as the TPU
// kernel gives it.
//
// What bounds it on this card: per walked (row, col) pair 6*d operations (s =
// q.k, dp = do.v, dq += ds.k) on 10*t*d bytes per (batch, head) plus lse,
// delta and the table: about 90 operations a byte on the training main path's
// layout, far below the ~295 bf16 operations a byte where the tensor cores
// become the limit, so device-memory bytes bound it. This first version does
// its products on the CUDA cores in f32, so it runs far from that bound;
// wgmma, TMA and warp specialisation are later work.
//
// Numerics follow the TPU kernel: f32 scores, p and ds (neither is rounded
// to the input dtype), f32 accumulator, dq rounded to q's dtype once.

#include "block_sparse_core.cuh"

namespace {

using block_sparse::Geom;
using block_sparse::stage;

template <int B, int D>
constexpr size_t smem_bytes() {
    using G = Geom<B, D>;
    // q, do tiles [B][DP], k, v tiles [SUB][DP], ds tile [B][SP]
    return sizeof(float) * (size_t)(2 * B * G::DP + 2 * G::SUB * G::DP + B * G::SP);
}

template <typename T, int B, int D>
__global__ void __launch_bounds__(Geom<B, D>::NT)
block_sparse_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const int* __restrict__ idx, const int* __restrict__ cnt,
                           T* __restrict__ dq, int t, int n_heads, int max_n, float scale,
                           int causal) {
    using G = Geom<B, D>;
    constexpr int NT = G::NT, SUB = G::SUB, CJ = G::CJ, DC = G::DC, DP = G::DP, SP = G::SP;
    extern __shared__ float smem[];
    float* qs = smem;                   // [B][DP]
    float* dos = qs + B * DP;           // [B][DP]
    float* ks = dos + B * DP;           // [SUB][DP]
    float* vs = ks + SUB * DP;          // [SUB][DP]
    float* dss = vs + SUB * DP;         // [B][SP]

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
    stage<T, D, B, DP, NT>(dos, dout + base + (size_t)q0 * D, tid);
    float lse_r[4], delta_r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const size_t row = (size_t)bh * t + q0 + ty * 4 + i;
        lse_r[i] = lse[row];
        delta_r[i] = delta[row];
    }

    float acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

    for (int n = 0; n < nnz; ++n) {
        const int kb = walk[n];
        for (int sub = 0; sub < B; sub += SUB) {
            const int k0 = kb * B + sub;
            __syncthreads();            // q/do are staged; the previous tile's k/ds reads are done
            stage<T, D, SUB, DP, NT>(ks, k + base + (size_t)k0 * D, tid);
            stage<T, D, SUB, DP, NT>(vs, v + base + (size_t)k0 * D, tid);
            __syncthreads();

            // s = q k^T and dp = do v^T, summed over d in the forward's order
            float s[4][CJ], dp[4][CJ];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
            for (int c = 0; c < D; ++c) {
                float qv[4], dv[4], kv[CJ], vv[CJ];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    qv[i] = qs[(ty * 4 + i) * DP + c];
                    dv[i] = dos[(ty * 4 + i) * DP + c];
                }
#pragma unroll
                for (int j = 0; j < CJ; ++j) {
                    kv[j] = ks[(tx + 16 * j) * DP + c];
                    vv[j] = vs[(tx + 16 * j) * DP + c];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < CJ; ++j) {
                        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
                        dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
                    }
            }

#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = ty * 4 + i;
                const int row = q0 + r;
#pragma unroll
                for (int j = 0; j < CJ; ++j) {
                    const int col = k0 + tx + 16 * j;
                    const float x = (causal && col > row) ? DS_NEG_INF : s[i][j] * scale;
                    const float p = expf(x - lse_r[i]);
                    dss[r * SP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * scale;
                }
            }
            __syncthreads();

            // dq += ds k
#pragma unroll 4
            for (int c = 0; c < SUB; ++c) {
                float kv[DC];
#pragma unroll
                for (int cc = 0; cc < DC; ++cc) kv[cc] = ks[c * DP + tx + 16 * cc];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float ds = dss[(ty * 4 + i) * SP + c];
#pragma unroll
                    for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(ds, kv[cc], acc[i][cc]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const size_t off = base + (size_t)(q0 + ty * 4 + i) * D;
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[off + tx + 16 * c] = from_f32<T>(acc[i][c]);
    }
}

struct Dq {
    template <typename T, int B, int D>
    static cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* idx,
                           const void* cnt, void* dq, int bh, int t, int n_heads, int max_n,
                           float scale, int causal, cudaStream_t stream) {
        return block_sparse::launch(
            block_sparse_bwd_dq_kernel<T, B, D>, smem_bytes<B, D>(), t / B, bh,
            Geom<B, D>::NT, stream, static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const T*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<const int*>(idx), static_cast<const int*>(cnt), static_cast<T*>(dq),
            t, n_heads, max_n, scale, causal);
    }
};

}  // namespace

// q, k, v, dout, dq: (bh, t, d) contiguous in `dtype`; lse, delta: (bh, t) f32;
// idx: (n_heads, t / block, max_n) and cnt: (n_heads, t / block) int32, the
// forward table. The head of row block i is i % n_heads. Returns
// cudaGetLastError().
extern "C" int block_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* idx, const void* cnt, void* dq, int bh, int t,
                                   int d, int n_heads, int block, int max_n, float scale,
                                   int causal, int dtype, void* stream) {
    if (block_sparse::bad_args(bh, t, n_heads, block, max_n)) return (int)cudaErrorInvalidValue;
    return (int)block_sparse::dispatch<Dq>(dtype, block, d, q, k, v, dout, lse, delta, idx, cnt,
                                           dq, bh, t, n_heads, max_n, scale, causal,
                                           static_cast<cudaStream_t>(stream));
}
