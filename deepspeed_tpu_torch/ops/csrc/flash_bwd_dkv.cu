// Flash-attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/flash.py:_bwd_dkv_kernel
// (launched by the second pallas_call in _flash_bwd): dk and dv of causal or
// full attention over q/k/v/do (b*h, t, d), recomputing the probabilities tile
// by tile from the forward's f32 logsumexp. The TPU grid walks q blocks as its
// sequential last axis and carries dk/dv in VMEM scratch; here one block owns a
// kv tile and walks the q tiles in a loop, from the first one that meets the
// causal triangle (_causal_q_lo), with dk and dv in registers. dq is the other
// kernel's (csrc/flash_bwd_dq.cu): two kernels, as in the JAX package, so no
// block adds into another's output, no atomics are needed and the gradients
// are the same on every run.
//
// What bounds it on this card: per causal (row, col) pair it does 8*d
// operations (s = q.k, dp = do.v, dv += p.do, dk += ds.q) on 12*t*d bytes per
// (batch, head) (q, k, v, do in, dk and dv out, plus f32 lse and delta), about
// t/3 operations a byte: ~340 at the training main path's t = 1024, just
// above the ~295 bf16 operations a byte where the H100's tensor cores become
// the limit. On the CUDA cores the products alone would take 1.16 ms at the
// training shape, 2.6x SDPA's whole backward.
//
// bf16 and fp16 (the kernel wgmma_dkv below) run all four products on the
// tensor cores with f32 sums, as the TPU kernel runs them on its MXU:
// - A block owns 64 kv rows per consumer warpgroup (one or two, picked by
//   shape in dkv_warpgroups) of one (b*h), plus one producer warpgroup.
//   K and V come in by TMA once and stay in shared memory.
// - The producer's first warp streams each q tile's Q and dO by TMA, and its
//   lse (times log2 e) and delta slices by plain loads, through a ring of
//   stages with full and empty mbarriers; with two consumer warpgroups,
//   setmaxnreg moves the producer's registers to the consumers.
// - S^T = K Q^T and dP^T = V dO^T are wgmma chains from shared memory (Q's
//   and dO's rows are K-major for the B operand). In registers, on the f32
//   accumulator fragments: P^T = exp(S^T scale + bias - lse), masked to 0
//   where the TPU kernel masks (only on tiles that meet the diagonal or t),
//   and dS^T = P^T (dP^T - delta) scale.
// - P^T is rounded to do's dtype and dS^T to q's dtype in registers (the TPU
//   kernel's roundings) and each is the register A operand of dV += P^T dO
//   and dK += dS^T Q, with dO and Q as MN-major B operands (the transpose
//   bit): the p and ds tiles never touch shared memory.
// - dk and dv stay in f32 registers for the block's life and are written
//   once, up to t. Under `causal` the blocks of kv tile 0, which walk every q
//   tile, start first, and a warpgroup skips tiles wholly above its rows.
// - Tiles are 3-D TMA boxes of (d, t, b*h): a box past t is zero-filled and
//   never reads the next head's rows.
//
// Head dims: built for D 64 and 128, with the real head_dim d (a multiple of
// 8, at most D) at run time, as csrc/flash_fwd.cu: d-wide TMA maps zero-fill
// the columns past d, rows lie d apart, stores stop at d.
//
// float32 keeps the first version's kernel (flash_bwd_dkv_kernel) on the CUDA
// cores: wgmma's only f32 input type is TF32 (~10 mantissa bits), while the TPU
// kernel takes f32 products in full f32. The choice is by dtype alone.
//
// Numerics of both kernels follow the TPU kernel and the forward
// (csrc/flash_fwd.cu): s is scaled, biased and masked as there, so p =
// exp(s - lse) is the forward's probability; p is rounded to do's dtype
// before the product with do, ds = p*(dp - delta)*scale to q's dtype before
// the product with q; dk and dv accumulate in f32. Rows and columns past t
// are masked, so any t works.
//
// First version's layout (float32; 256 threads, one 64-row kv tile of one
// (batch, head)): thread (ty, tx) = (tid / 16, tid % 16) owns kv rows 4*ty ..
// 4*ty+3; of each transposed 64-column score tile it computes q columns
// tx + 16*j, and of dk and dv the columns tx + 16*c. Shared memory holds k, v,
// q, do as f32 tiles with padded rows, the f32 p and ds tiles and the tile's
// lse and delta: 166 KB at d = 128, so it is dynamic shared memory.

#include "hopper.cuh"
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
                     T* __restrict__ dk, T* __restrict__ dv, int t, int d, int n_heads,
                     float scale, int causal) {
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
    const size_t base = (size_t)bh * t * d;      // rows d apart; columns d .. D-1 zero
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
        const bool ok = row < t && c < d;
        const size_t idx = base + (size_t)row * d + c;
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
            const int row = q0 + vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
            const size_t idx = base + (size_t)row * d + c;
            const bool ok = row < t && c < d;
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
            const size_t off = base + (size_t)row * d;
#pragma unroll
            for (int c = 0; c < DC; ++c) {
                if (tx + 16 * c >= d) continue;
                dk[off + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
                dv[off + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
            }
        }
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* slopes, void* dk, void* dv,
                   int bh, int t, int d, int n_heads, float scale, int causal,
                   cudaStream_t stream) {
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
        static_cast<T*>(dk), static_cast<T*>(dv), t, d, n_heads, scale, causal);
    return cudaGetLastError();
}

// ------------------------------------------------ bf16 / fp16: wgmma and TMA

namespace wg {

using namespace hopper;

constexpr int BQ = 64;          // q rows per tile of the walk

template <int D, int NWG>
struct Cfg {
    static constexpr int NP = D / PANEL;                   // 64-column panels of a row
    static constexpr int NST = D == 64 ? 3 : 2;            // stages of the q/do ring
    static constexpr int THREADS = 128 * (NWG + 1);
    static constexpr int KV_BYTES = 2 * NWG * NP * PANEL_BYTES;    // K panels, then V panels
    static constexpr int TILE_BYTES = 2 * NP * PANEL_BYTES;        // Q panels, then dO panels
    // lse and delta (2 x 64 f32) after the tiles, padded so stages stay 1024-aligned
    static constexpr int STAGE_BYTES = TILE_BYTES + 1024;
    static constexpr size_t SMEM = 1024 + KV_BYTES + NST * STAGE_BYTES + 8 * (1 + 2 * NST);
    // setmaxnreg with two consumer warpgroups: the 168 registers a thread of
    // the launch bound, moved from the producer to the consumers (128 x 40 +
    // 256 x 232 = 128 x 24 + 256 x 240 = 384 x 168). At D 128 each consumer
    // holds dk and dv (2 x 64 f32 registers) beside S, dP and their fragments
    // and needs the last 8: at 232 ptxas spilled 20 bytes.
    static constexpr int PRODUCER_REGS = D == 128 ? 24 : 40;
    static constexpr int CONSUMER_REGS = D == 128 ? 240 : 232;
};

template <typename T, int D, int NWG, bool EXACT>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
wgmma_dkv(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ slopes, T* __restrict__ dk, T* __restrict__ dv, int t,
          int d, int n_heads, float scale, int causal) {
    using C = Cfg<D, NWG>;
    constexpr int NP = C::NP, NST = C::NST;
    // the exact build (d == D) folds the strides and guards below to constants
    if constexpr (EXACT) d = D;

    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t k_s = (raw + 1023) & ~1023u;
    uint8_t* const gen = smem_raw + (k_s - raw);             // k_s as a generic pointer
    const uint32_t v_s = k_s + NWG * NP * PANEL_BYTES;
    const uint32_t ring = k_s + C::KV_BYTES;
    const uint32_t kv_full = ring + NST * C::STAGE_BYTES;    // then full[NST], empty[NST]
    auto full = [&](int s) { return kv_full + 8 * (1 + s); };
    auto empty = [&](int s) { return kv_full + 8 * (1 + NST + s); };
    // a stage's lse (log2 units) and delta, as generic pointers
    auto stage_rows = [&](int s) {
        return reinterpret_cast<float*>(gen + C::KV_BYTES + s * C::STAGE_BYTES + C::TILE_BYTES);
    };

    const int bh = blockIdx.x;
    const int k0 = blockIdx.y * 64 * NWG;      // tile 0, which walks every q tile, first
    const int nq = (t + BQ - 1) / BQ;
    const int q_lo = causal ? k0 / BQ : 0;     // first q tile meeting the triangle
    const int q_end = nq;

    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < NST; ++s) {
            mbar_init(full(s), 32);
            mbar_init(empty(s), 128 * NWG);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wgi = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    if (wgi == NWG) {
        // producer: its first warp loads; lane 0 issues the TMA copies
        if constexpr (NWG == 2) setmaxnreg_dec<C::PRODUCER_REGS>();
        if (threadIdx.x / 32 == 4 * NWG) {
            if (lane == 0) {
                mbar_arrive_expect_tx(kv_full, C::KV_BYTES);
                for (int w = 0; w < NWG; ++w)
                    for (int p = 0; p < NP; ++p) {
                        tma_load_3d(k_s + (w * NP + p) * PANEL_BYTES, &tm_k, kv_full,
                                    PANEL * p, k0 + 64 * w, bh);
                        tma_load_3d(v_s + (w * NP + p) * PANEL_BYTES, &tm_v, kv_full,
                                    PANEL * p, k0 + 64 * w, bh);
                    }
            }
            for (int qt = q_lo; qt < q_end; ++qt) {
                const int it = qt - q_lo, s = it % NST, q0 = qt * BQ;
                if (it >= NST) mbar_wait(empty(s), (it / NST - 1) & 1);
                float* rows = stage_rows(s);
                for (int r = lane; r < BQ; r += 32) {
                    const bool ok = q0 + r < t;
                    rows[r] = ok ? lse[(size_t)bh * t + q0 + r] * LOG2E : 0.f;
                    rows[BQ + r] = ok ? delta[(size_t)bh * t + q0 + r] : 0.f;
                }
                if (lane == 0) {
                    mbar_arrive_expect_tx(full(s), C::TILE_BYTES);
                    const uint32_t st = ring + s * C::STAGE_BYTES;
                    for (int p = 0; p < NP; ++p) {
                        tma_load_3d(st + p * PANEL_BYTES, &tm_q, full(s), PANEL * p, q0, bh);
                        tma_load_3d(st + (NP + p) * PANEL_BYTES, &tm_do, full(s), PANEL * p, q0,
                                    bh);
                    }
                } else {
                    mbar_arrive(full(s));
                }
            }
        }
    } else {
        // consumer warpgroup wgi: kv rows kv0 .. kv0 + 63
        if constexpr (NWG == 2) setmaxnreg_inc<C::CONSUMER_REGS>();
        const int warp = (threadIdx.x % 128) / 32;
        const int kv0 = k0 + 64 * wgi;
        const int ra = kv0 + 16 * warp + lane / 4;           // this thread's kv rows: ra, ra + 8
        const float sl2 = scale * LOG2E;
        const float slope2 = slopes != nullptr ? slopes[bh % n_heads] * LOG2E : 0.f;
        const uint32_t kw = k_s + wgi * NP * PANEL_BYTES, vw = v_s + wgi * NP * PANEL_BYTES;

        float dk_acc[NP][32], dv_acc[NP][32];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;

        mbar_wait(kv_full, 0);
        for (int qt = q_lo; qt < q_end; ++qt) {
            const int it = qt - q_lo, s = it % NST, q0 = qt * BQ;
            mbar_wait(full(s), (it / NST) & 1);
            if (!causal || q0 + BQ - 1 >= kv0) {
                const uint32_t qs = ring + s * C::STAGE_BYTES, dos = qs + NP * PANEL_BYTES;
                float sc[32], dp[32];
#pragma unroll
                for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const uint32_t off = (kk / 4) * PANEL_BYTES + 32 * (kk % 4);
                    mma_ss<T, 0>(sc, desc(kw + off), desc(qs + off), kk > 0);
                    mma_ss<T, 0>(dp, desc(vw + off), desc(dos + off), kk > 0);
                }
                wg_commit();
                wg_wait0();
                reg_fence(sc);
                reg_fence(dp);

                const float* rows = stage_rows(s);
                const bool mask_causal = causal && q0 < kv0 + 64;   // the tile meets the diagonal
                const bool ragged = q0 + BQ > t || kv0 + 64 > t;
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int qi = 8 * j + 2 * (lane % 4) + (e & 1);
                        const int row = q0 + qi;                 // the query's position
                        const int col = ra + 8 * (e >> 1);       // the key's position
                        float x = sc[4 * j + e] * sl2;
                        if (slopes != nullptr) x += slope2 * (float)(col - row);
                        bool valid = !ragged || (row < t && col < t);
                        if (mask_causal) valid = valid && col <= row;
                        const float p = valid ? exp2f(x - rows[qi]) : 0.f;
                        sc[4 * j + e] = p;
                        dp[4 * j + e] = p * (dp[4 * j + e] - rows[BQ + qi]) * scale;
                    }
                uint32_t pa[4][4], dsa[4][4];
                acc_to_afrag<T>(sc, pa);           // p rounded to do's dtype
                acc_to_afrag<T>(dp, dsa);          // ds rounded to q's dtype
                wg_fence();
#pragma unroll
                for (int p = 0; p < NP; ++p)
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        mma_rs<T, 1>(dv_acc[p], pa[kk], desc(dos + p * PANEL_BYTES + 2048 * kk));
                        mma_rs<T, 1>(dk_acc[p], dsa[kk], desc(qs + p * PANEL_BYTES + 2048 * kk));
                    }
                wg_commit();
                wg_wait0();
#pragma unroll
                for (int p = 0; p < NP; ++p) {
                    reg_fence(dv_acc[p]);
                    reg_fence(dk_acc[p]);
                }
            }
            mbar_arrive(empty(s));
        }

        // a run-time d made opaque here, so the compiler does not hoist the
        // epilogue's row addresses above the walk, where dk and dv hold every
        // register
        int dw = d;
        if constexpr (!EXACT) asm volatile("" : "+r"(dw));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = ra + 8 * i;
            if (row < t) {
                const size_t off = ((size_t)bh * t + row) * dw;
#pragma unroll
                for (int p = 0; p < NP; ++p)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        if (PANEL * p + 8 * j >= dw) continue;    // d is a multiple of 8
                        const int c = PANEL * p + 8 * j + 2 * (lane % 4), a = 4 * j + 2 * i;
                        *reinterpret_cast<uint32_t*>(dk + off + c) =
                            pack2<T>(dk_acc[p][a], dk_acc[p][a + 1]);
                        *reinterpret_cast<uint32_t*>(dv + off + c) =
                            pack2<T>(dv_acc[p][a], dv_acc[p][a + 1]);
                    }
            }
        }
    }
}

// consumer warpgroups a block: two (128 kv rows) where that still gives every
// SM at least two blocks, else one, from the sweep in
// benchmarks/torch/qmm_versions.py; DS_FLASH_DKV_WG=1|2 at build time
// forces one, for that sweep
inline int dkv_warpgroups(int bh, int t) {
#ifdef DS_FLASH_DKV_WG
    return DS_FLASH_DKV_WG;
#else
    return (long long)bh * ((t + 127) / 128) >= 2 * 132 ? 2 : 1;
#endif
}

template <typename T, int D, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* slopes, void* dk, void* dv,
                   int bh, int t, int d, int n_heads, float scale, int causal,
                   cudaStream_t stream) {
    using C = Cfg<D, NWG>;
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err;
    // maps d wide: columns past d come in as zeros (flash_fwd.cu)
    if ((err = make_map_3d(&mq, q, bh, t, d, bf16)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mk, k, bh, t, d, bf16)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mv, v, bh, t, d, bf16)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mdo, dout, bh, t, d, bf16)) != cudaSuccess) return err;
    auto* kernel = d == D ? wgmma_dkv<T, D, NWG, true> : wgmma_dkv<T, D, NWG, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (t + 64 * NWG - 1) / (64 * NWG));
    kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const float*>(slopes), static_cast<T*>(dk), static_cast<T*>(dv), t, d,
        n_heads, scale, causal);
    return cudaGetLastError();
}

}  // namespace wg

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* slopes, void* dk,
                       void* dv, int bh, int t, int d, int n_heads, float scale, int causal,
                       cudaStream_t stream) {
    const int width = build_width(d, 128);
    if constexpr (std::is_same<T, float>::value) {
        if (width == 64)
            return launch<T, 64>(q, k, v, dout, lse, delta, slopes, dk, dv, bh, t, d, n_heads,
                                 scale, causal, stream);
        if (width == 128)
            return launch<T, 128>(q, k, v, dout, lse, delta, slopes, dk, dv, bh, t, d, n_heads,
                                  scale, causal, stream);
    } else {
        const bool two = wg::dkv_warpgroups(bh, t) == 2;
        if (width == 64)
            return two ? wg::launch<T, 64, 2>(q, k, v, dout, lse, delta, slopes, dk, dv, bh, t,
                                              d, n_heads, scale, causal, stream)
                       : wg::launch<T, 64, 1>(q, k, v, dout, lse, delta, slopes, dk, dv, bh, t,
                                              d, n_heads, scale, causal, stream);
        if (width == 128)
            return two ? wg::launch<T, 128, 2>(q, k, v, dout, lse, delta, slopes, dk, dv, bh,
                                               t, d, n_heads, scale, causal, stream)
                       : wg::launch<T, 128, 1>(q, k, v, dout, lse, delta, slopes, dk, dv, bh,
                                               t, d, n_heads, scale, causal, stream);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout, dk, dv: (bh, t, d) contiguous in `dtype`, d a multiple of 8
// up to 128; lse, delta: (bh, t)
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
