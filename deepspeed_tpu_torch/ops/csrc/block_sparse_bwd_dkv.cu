// Block-sparse attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/block_sparse.py:_bwd_dkv_kernel
// (launched by the second pallas_call in _bs_bwd): dk and dv of block-sparse
// attention over q/k/v/do (b*h, t, d). One thread block owns one (b*h,
// k-block) and walks the transposed table (idx (H, nb, max_n), cnt (H, nb):
// the q-blocks that attend to this k-block, read from device memory; head
// i % n_heads), recomputing the probabilities tile by tile from the forward's
// f32 logsumexp; dk and dv stay in registers and are written once. dq is the
// other kernel's (csrc/block_sparse_bwd_dq.cu), so no block adds into
// another's output: no atomics, and the gradients are the same on every run.
//
// Masking is the forward's: a masked score is -1e30 and p = exp(s - lse), so
// a row with a valid key gives a masked entry p = 0, and a row whose walked
// entries are all masked (lse about -1e30) gives each p = 1, as the TPU
// kernel does.
//
// What bounds it on this card: per walked (row, col) pair 8*d operations (s =
// q.k, dp = do.v, dv += p.do, dk += ds.q) on 12*t*d bytes per (batch, head)
// plus lse, delta and the table: about 100 operations a byte on the training
// main path's layout, far below the ~295 bf16 operations a byte where the
// tensor cores become the limit, so device-memory bytes bound it. This first
// version does its products on the CUDA cores in f32, so it runs far from
// that bound. The work is uneven: a global column block is walked by every
// later q-block (up to 64 at t 1024 and block 16), a local one by at most 4,
// so a few blocks run 16x longer than the rest; splitting long walks over
// several blocks with a second reduction pass is later work, as are wgmma,
// TMA and warp specialisation.
//
// Numerics follow the TPU kernel: f32 scores, p and ds (neither is rounded
// to the input dtype), f32 accumulators, dk and dv rounded to their dtype
// once.

#include "block_sparse_core.cuh"

namespace {

using block_sparse::Geom;
using block_sparse::stage;

template <int B, int D>
constexpr size_t smem_bytes() {
    using G = Geom<B, D>;
    // k, v tiles [B][DP], q, do tiles [SUB][DP], p and ds tiles [B][SP], lse and delta [SUB]
    return sizeof(float) *
           (size_t)(2 * B * G::DP + 2 * G::SUB * G::DP + 2 * B * G::SP + 2 * G::SUB);
}

template <typename T, int B, int D>
__global__ void __launch_bounds__(Geom<B, D>::NT)
block_sparse_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const int* __restrict__ idx, const int* __restrict__ cnt,
                            T* __restrict__ dk, T* __restrict__ dv, int t, int n_heads,
                            int max_n, float scale, int causal) {
    using G = Geom<B, D>;
    constexpr int NT = G::NT, SUB = G::SUB, CJ = G::CJ, DC = G::DC, DP = G::DP, SP = G::SP;
    extern __shared__ float smem[];
    float* ks = smem;                   // [B][DP]
    float* vs = ks + B * DP;            // [B][DP]
    float* qs = vs + B * DP;            // [SUB][DP]
    float* dos = qs + SUB * DP;         // [SUB][DP]
    float* ps = dos + SUB * DP;         // [B][SP]
    float* dss = ps + B * SP;           // [B][SP]
    float* lse_s = dss + B * SP;        // [SUB]
    float* delta_s = lse_s + SUB;       // [SUB]

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int kb = blockIdx.x;
    const int bh = blockIdx.y;
    const int nb = t / B;
    const int head = bh % n_heads;
    const int k0 = kb * B;
    const size_t base = (size_t)bh * t * D;
    const size_t row_base = (size_t)bh * t;
    const int* walk = idx + ((size_t)head * nb + kb) * max_n;
    const int nnz = cnt[head * nb + kb];

    stage<T, D, B, DP, NT>(ks, k + base + (size_t)k0 * D, tid);
    stage<T, D, B, DP, NT>(vs, v + base + (size_t)k0 * D, tid);

    float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

    for (int n = 0; n < nnz; ++n) {
        const int qb = walk[n];
        for (int sub = 0; sub < B; sub += SUB) {
            const int q0 = qb * B + sub;
            __syncthreads();            // k/v are staged; the previous tile's q/do/p/ds reads are done
            stage<T, D, SUB, DP, NT>(qs, q + base + (size_t)q0 * D, tid);
            stage<T, D, SUB, DP, NT>(dos, dout + base + (size_t)q0 * D, tid);
            if (tid < SUB) {
                lse_s[tid] = lse[row_base + q0 + tid];
                delta_s[tid] = delta[row_base + q0 + tid];
            }
            __syncthreads();

            // s^T = k q^T and dp^T = v do^T, summed over d in the forward's order
            float s[4][CJ], dp[4][CJ];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
            for (int c = 0; c < D; ++c) {
                float kv[4], vv[4], qv[CJ], dov[CJ];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    kv[i] = ks[(ty * 4 + i) * DP + c];
                    vv[i] = vs[(ty * 4 + i) * DP + c];
                }
#pragma unroll
                for (int j = 0; j < CJ; ++j) {
                    qv[j] = qs[(tx + 16 * j) * DP + c];
                    dov[j] = dos[(tx + 16 * j) * DP + c];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < CJ; ++j) {
                        s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
                        dp[i][j] = fmaf(dov[j], vv[i], dp[i][j]);
                    }
            }

#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = ty * 4 + i;
                const int col = k0 + r;                 // the key's position
#pragma unroll
                for (int j = 0; j < CJ; ++j) {
                    const int qj = tx + 16 * j;
                    const int row = q0 + qj;            // the query's position
                    const float x = (causal && col > row) ? DS_NEG_INF : s[i][j] * scale;
                    const float p = expf(x - lse_s[qj]);
                    ps[r * SP + qj] = p;
                    dss[r * SP + qj] = p * (dp[i][j] - delta_s[qj]) * scale;
                }
            }
            __syncthreads();

            // dv += p^T do, dk += ds^T q
#pragma unroll 4
            for (int c = 0; c < SUB; ++c) {
                float dov[DC], qv[DC];
#pragma unroll
                for (int cc = 0; cc < DC; ++cc) {
                    dov[cc] = dos[c * DP + tx + 16 * cc];
                    qv[cc] = qs[c * DP + tx + 16 * cc];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p = ps[(ty * 4 + i) * SP + c];
                    const float ds = dss[(ty * 4 + i) * SP + c];
#pragma unroll
                    for (int cc = 0; cc < DC; ++cc) {
                        dv_acc[i][cc] = fmaf(p, dov[cc], dv_acc[i][cc]);
                        dk_acc[i][cc] = fmaf(ds, qv[cc], dk_acc[i][cc]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const size_t off = base + (size_t)(k0 + ty * 4 + i) * D;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
            dk[off + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
            dv[off + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
        }
    }
}

struct Dkv {
    template <typename T, int B, int D>
    static cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* idx,
                           const void* cnt, void* dk, void* dv, int bh, int t, int n_heads,
                           int max_n, float scale, int causal, cudaStream_t stream) {
        return block_sparse::launch(
            block_sparse_bwd_dkv_kernel<T, B, D>, smem_bytes<B, D>(), t / B, bh,
            Geom<B, D>::NT, stream, static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const T*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<const int*>(idx), static_cast<const int*>(cnt), static_cast<T*>(dk),
            static_cast<T*>(dv), t, n_heads, max_n, scale, causal);
    }
};

}  // namespace

// q, k, v, dout, dk, dv: (bh, t, d) contiguous in `dtype`; lse, delta: (bh, t)
// f32; idx: (n_heads, t / block, max_n) and cnt: (n_heads, t / block) int32,
// the transposed table. The head of row block i is i % n_heads. Returns
// cudaGetLastError().
extern "C" int block_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* idx, const void* cnt, void* dk, void* dv,
                                    int bh, int t, int d, int n_heads, int block, int max_n,
                                    float scale, int causal, int dtype, void* stream) {
    if (block_sparse::bad_args(bh, t, n_heads, block, max_n)) return (int)cudaErrorInvalidValue;
    return (int)block_sparse::dispatch<Dkv>(dtype, block, d, q, k, v, dout, lse, delta, idx,
                                            cnt, dk, dv, bh, t, n_heads, max_n, scale, causal,
                                            static_cast<cudaStream_t>(stream));
}
