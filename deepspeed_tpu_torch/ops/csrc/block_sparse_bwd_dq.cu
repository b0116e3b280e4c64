// Block-sparse attention backward, dq, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/block_sparse.py:_bwd_dq_kernel
// (launched by the first pallas_call in _bs_bwd): dq of block-sparse
// attention over q/k/v/do (b*h, t, d), walking for each q-block the forward
// table (head i % n_heads) and recomputing the probabilities from the
// forward's f32 logsumexp, so the score, dp and ds tiles never reach device
// memory; dq stays in registers and is written once. delta = rowsum(do * o)
// comes in from outside the kernel, as in the JAX package.
//
// Masking is the forward's: a masked score is -1e30 and p = exp(s - lse), so
// on a row with a valid key a masked entry gets p = 0, and on a row whose
// walked entries are all masked (lse -1e30) each gets p = 1, as the TPU
// kernel gives it. Numerics follow the TPU kernel: f32 scores, p and ds
// (neither is rounded to the input dtype), f32 accumulator, dq rounded to q's
// dtype once.
//
// What bounds it on this card: per walked (row, col) pair 6*d operations (s =
// q.k, dp = do.v, dq += ds.k) on 10*t*d bytes per (batch, head) plus lse,
// delta and the table: about 90 operations a byte on the training main path's
// layout (Fixed, block 16, t 1024), far below the ~295 bf16 operations a byte
// where the tensor cores become the limit, so device-memory bytes bound it
// (0.057 ms at (24, 12, 1024, 64)).
//
// bf16 and fp16 (the kernel wgmma_bs_dq below): the pipeline of wgmma_dq
// (flash_bwd_dq.cu) walking the forward's tile tables as wgmma_bs_fwd
// (block_sparse_fwd.cu) walks them.
// - Tiles. The kernel works in units of U = min(block, 64) rows. A consumer
//   warpgroup owns 64 q rows: 64 / U consecutive q-units (a 64-row slice of
//   one q-block at block 128), and walks the UNION of their k-units in
//   ascending order, 64 columns (64 / U entries) a stage. The table of
//   ops/attention/block_sparse.py:build_tile_tables (K8's, unchanged) gives
//   each entry's k-unit with a bitmask of the tile's q-units that own it,
//   pads a tile's last stage with a repeat of a real unit that no row owns,
//   and launches the longest walks first. At block 16 a stage does 64 rows of
//   work per K/V load where the first version did 16.
// - Q and dO of the tile come in once by TMA (64-row boxes) and stay in
//   shared memory; each consumer thread keeps its rows' lse (times log2 e)
//   and delta in registers. A producer thread streams each stage's K and V by
//   TMA through a ring of full/empty mbarrier stages, one box of U rows a slot
//   into its place in a 64-row 128-byte-swizzled panel, as wgmma_bs_fwd loads
//   them. Maps are 3-D over (d, t, b*h): a box never reads another head's
//   rows, and a q box past t is zero-filled.
// - S = Q K^T (wgmma_bs_fwd's k-steps in its order, so s is the score the
//   lse came from) and dP = dO V^T are wgmma chains from shared memory with K
//   and V K-major; on the f32 fragments P = exp(S scale - lse) and dS = P (dP
//   - delta) scale; then dQ += dS K with K's panel read MN-major (the
//   transpose bit), as in wgmma_dq: one K load serves S and dQ.
// - To keep the TPU kernel's f32 ds on 16-bit tensor cores, ds is split into
//   hi (rounded to T) and lo (the rest, rounded to T) and both go into the
//   one f32 dQ accumulator as register A operands (4 products a stage, as
//   wgmma_bs_dkv splits p and ds). K is exact in T, so each term keeps ~16
//   (bf16) or ~22 (fp16) bits of ds and no rounding flips at a halfway point:
//   wgmma_dq's in-order recompute of a ds near one is not needed. P itself
//   is never an operand.
// - Two masks, as in wgmma_bs_fwd and wgmma_bs_dkv, because the union walk
//   shows a row k entries that the TPU kernel never walks for it: an entry
//   whose owner bit is clear (or padding) scores -inf, so p = 0 and ds = 0
//   even on rows whose lse is -1e30; a walked but causally masked one (col >
//   row) scores the finite -1e30 of _bwd_dq_kernel, scaled by log2 e as the
//   lse is, so a row whose walked entries are all masked gets p = 1 exactly.
//   A stage that every row of the tile owns wholly and that lies wholly at or
//   below the tile's first row skips both.
// - dq is rounded once and written for the rows below t; a tile whose walk is
//   empty writes zeros (the output is uninitialised). One launch a call, the
//   longest walks first, none split over blocks.
//
// Head dims: built for D 64 and 128, with the real head_dim d (a multiple of
// 8, at most D) at run time, as csrc/flash_fwd.cu: d-wide TMA maps zero-fill
// the columns past d, rows lie d apart, stores stop at d (the f32 kernel
// stages zeros past d).
//
// float32 keeps the first version's kernel (block_sparse_bwd_dq_kernel) on
// the CUDA cores, chosen by dtype alone as in K1, K3, K4, K6, K8 and K10:
// wgmma's only f32 input is TF32 (~10 mantissa bits), which would fail the
// f32 limits. That kernel: one block of 4*B threads a (b*h, q-block) walking
// its row of the forward table, inputs widened to f32 in shared memory, all
// three products on the CUDA cores.

#include "hopper.cuh"
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
                           T* __restrict__ dq, int t, int d, int n_heads, int max_n,
                           float scale, int causal) {
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
    const size_t base = (size_t)bh * t * d;
    const int* walk = idx + ((size_t)head * nb + qb) * max_n;
    const int nnz = cnt[head * nb + qb];

    stage<T, D, B, DP, NT>(qs, q + base + (size_t)q0 * d, d, tid);
    stage<T, D, B, DP, NT>(dos, dout + base + (size_t)q0 * d, d, tid);
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
            stage<T, D, SUB, DP, NT>(ks, k + base + (size_t)k0 * d, d, tid);
            stage<T, D, SUB, DP, NT>(vs, v + base + (size_t)k0 * d, d, tid);
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
        const size_t off = base + (size_t)(q0 + ty * 4 + i) * d;
#pragma unroll
        for (int c = 0; c < DC; ++c)
            if (tx + 16 * c < d) dq[off + tx + 16 * c] = from_f32<T>(acc[i][c]);
    }
}

struct Dq {
    template <typename T, int B, int D>
    static cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* idx,
                           const void* cnt, void* dq, int bh, int t, int d, int n_heads,
                           int max_n, float scale, int causal, cudaStream_t stream) {
        return block_sparse::launch(
            block_sparse_bwd_dq_kernel<T, B, D>, smem_bytes<B, D>(), t / B, bh,
            Geom<B, D>::NT, stream, static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const T*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<const int*>(idx), static_cast<const int*>(cnt), static_cast<T*>(dq),
            t, d, n_heads, max_n, scale, causal);
    }
};

// ------------------------------------------------ bf16 / fp16: wgmma and TMA

namespace wg {

using namespace hopper;

template <int D>
struct Cfg {
    static constexpr int NP = D / PANEL;                      // 64-column panels of a row
    static constexpr int NST = D == 64 ? 3 : 2;               // stages of the K/V ring
    static constexpr int THREADS = 256;                       // a consumer, a producer
    static constexpr int Q_BYTES = NP * PANEL_BYTES;          // the q tile; dO's is as large
    static constexpr int STAGE_BYTES = 2 * NP * PANEL_BYTES;  // K panels, then V panels
    // 1024 bytes of slack to align the tiles, then q, do, the ring, the barriers
    static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + NST * STAGE_BYTES + 8 * (1 + 2 * NST);
};

// One block: tile `order[blockIdx.x / n_batch]` = head * n_tiles + tile of
// batch blockIdx.x % n_batch; 64 q rows from tile * 64. Units of 2^log2u
// rows; an entry is k_unit << 8 | owner bits (bit g: the tile's q-unit g owns
// it); a tile's entries are padded to whole stages of 64 >> log2u.
template <typename T, int D>
__global__ void __launch_bounds__(256, D == 64 ? 2 : 1)
wgmma_bs_dq(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ tile_idx, const int* __restrict__ tile_cnt,
            const int* __restrict__ tile_order, T* __restrict__ dq, int t, int d, int n_heads,
            int n_batch, int n_tiles, int max_slots, int log2u, float scale, int causal) {
    using C = Cfg<D>;
    constexpr int NP = C::NP, NST = C::NST;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
    const uint32_t do_s = q_s + C::Q_BYTES;
    const uint32_t ring = do_s + C::Q_BYTES;
    const uint32_t q_full = ring + NST * C::STAGE_BYTES;     // then full[NST], empty[NST]
    auto full = [&](int s) { return q_full + 8 * (1 + s); };
    auto empty = [&](int s) { return q_full + 8 * (1 + NST + s); };

    const int ht = tile_order[blockIdx.x / n_batch];
    const int head = ht / n_tiles, tile = ht % n_tiles;
    const int bh = (int)(blockIdx.x % n_batch) * n_heads + head;
    const int unit = 1 << log2u;
    const int slots = 64 >> log2u;                           // entries a stage
    const int* ents = tile_idx + (size_t)ht * max_slots;
    const int n_st = (tile_cnt[ht] + slots - 1) / slots;
    const int q0 = tile * 64;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < NST; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 128);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x >= 128) {
        // producer: one thread issues every load
        if (threadIdx.x == 128) {
            mbar_arrive_expect_tx(q_full, 2 * C::Q_BYTES);
            for (int p = 0; p < NP; ++p) {
                tma_load_3d(q_s + p * PANEL_BYTES, &tm_q, q_full, PANEL * p, q0, bh);
                tma_load_3d(do_s + p * PANEL_BYTES, &tm_do, q_full, PANEL * p, q0, bh);
            }
            for (int st = 0; st < n_st; ++st) {
                const int s = st % NST;
                if (st >= NST) mbar_wait(empty(s), (st / NST - 1) & 1);
                mbar_arrive_expect_tx(full(s), C::STAGE_BYTES);
                const uint32_t base = ring + s * C::STAGE_BYTES;
                for (int slot = 0; slot < slots; ++slot) {
                    const int k0 = (ents[st * slots + slot] >> 8) * unit;
                    const uint32_t at = base + slot * unit * 128;    // unit rows of 128 bytes
                    for (int p = 0; p < NP; ++p) {
                        tma_load_3d(at + p * PANEL_BYTES, &tm_k, full(s), PANEL * p, k0, bh);
                        tma_load_3d(at + (NP + p) * PANEL_BYTES, &tm_v, full(s), PANEL * p, k0,
                                    bh);
                    }
                }
            }
        }
    } else {
        // consumer warpgroup: q rows q0 .. q0 + 63
        const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
        const int ra = q0 + 16 * warp + lane / 4;            // this thread's rows: ra, ra + 8
        const int g = (16 * warp) >> log2u;                  // their q-unit in the tile
        const int wg_bits = (1 << slots) - 1;                // the tile's q-units
        const float sl2 = scale * LOG2E;                     // scores in log2 units
        const float excluded = __int_as_float((int)0xff800000);   // -inf: not the row's entry
        const float masked = DS_NEG_INF * LOG2E;             // -1e30, as lse * log2 e
        // rows past t (the last tile of a ragged t) own nothing: finite stand-ins
        float lse2[2], dl[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = ra + 8 * i;
            lse2[i] = row < t ? lse[(size_t)bh * t + row] * LOG2E : 0.f;
            dl[i] = row < t ? delta[(size_t)bh * t + row] : 0.f;
        }

        float acc[NP][32];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

        mbar_wait(q_full, 0);
        for (int st = 0; st < n_st; ++st) {
            const int s = st % NST;
            // the stage's entries (slots beyond `slots` repeat the first)
            int e[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) e[i] = __ldg(ents + st * slots + (i < slots ? i : 0));
            int all_own = 0xFF;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (i < slots) all_own &= e[i];
            const int e_last = slots == 1 ? e[0] : slots == 2 ? e[1] : e[3];
            mbar_wait(full(s), (st / NST) & 1);
            const uint32_t ks = ring + s * C::STAGE_BYTES, vs = ks + NP * PANEL_BYTES;
            float sc[32], dp[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t off = (kk / 4) * PANEL_BYTES + 32 * (kk % 4);
                mma_ss<T, 0>(sc, desc(q_s + off), desc(ks + off), kk > 0);
                mma_ss<T, 0>(dp, desc(do_s + off), desc(vs + off), kk > 0);
            }
            wg_commit();
            wg_wait0();
            reg_fence(sc);
            reg_fence(dp);

            const bool need_mask = (all_own & wg_bits) != wg_bits ||
                                   (causal && ((e_last >> 8) + 1) * unit - 1 > q0);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                // columns 8j .. 8j+7 of the stage lie in one entry
                const int slot = (8 * j) >> log2u;
                const int ej = slot == 0 ? e[0] : slot == 1 ? e[1] : slot == 2 ? e[2] : e[3];
                const bool own = (ej >> g) & 1;
                const int col0 = (ej >> 8) * unit + ((8 * j) & (unit - 1)) + 2 * (lane % 4);
#pragma unroll
                for (int f = 0; f < 4; ++f) {
                    float x = sc[4 * j + f] * sl2;
                    if (need_mask) {
                        const int col = col0 + (f & 1), row = ra + 8 * (f >> 1);
                        x = !own ? excluded : (causal && col > row) ? masked : x;
                    }
                    const float p = exp2f(x - lse2[f >> 1]);
                    dp[4 * j + f] = p * (dp[4 * j + f] - dl[f >> 1]) * scale;
                }
            }
            uint32_t ds_hi[4][4], ds_lo[4][4];
            acc_to_afrag_split<T>(dp, ds_hi, ds_lo);
            wg_fence();
#pragma unroll
            for (int p = 0; p < NP; ++p)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const uint64_t bk = desc(ks + p * PANEL_BYTES + 2048 * kk);
                    mma_rs<T, 1>(acc[p], ds_hi[kk], bk);
                    mma_rs<T, 1>(acc[p], ds_lo[kk], bk);
                }
            wg_commit();
            wg_wait0();
#pragma unroll
            for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
            mbar_arrive(empty(s));
        }

        // an empty walk leaves acc at 0: its rows get zeros
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* tile_idx,
                   const void* tile_cnt, const void* tile_order, void* dq, int bh, int t,
                   int d, int n_heads, int block, int max_slots, float scale, int causal,
                   cudaStream_t stream) {
    using C = Cfg<D>;
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    const int unit = block < 64 ? block : 64;
    const int log2u = unit == 16 ? 4 : unit == 32 ? 5 : 6;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err;
    // maps d wide: columns past d come in as zeros (flash_fwd.cu)
    if ((err = make_map_3d(&mq, q, bh, t, d, bf16)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mk, k, bh, t, d, bf16, unit)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mv, v, bh, t, d, bf16, unit)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mdo, dout, bh, t, d, bf16)) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(wgmma_bs_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
    if (err != cudaSuccess) return err;
    const int n_tiles = (t + 63) / 64;
    wgmma_bs_dq<T, D><<<bh * n_tiles, C::THREADS, C::SMEM, stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(tile_idx), static_cast<const int*>(tile_cnt),
        static_cast<const int*>(tile_order), static_cast<T*>(dq), t, d, n_heads, bh / n_heads,
        n_tiles, max_slots, log2u, scale, causal);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* tile_idx,
                     const void* tile_cnt, const void* tile_order, void* dq, int bh, int t,
                     int n_heads, int block, int max_slots, float scale, int causal,
                     cudaStream_t stream) {
    if (build_width(d, 128) == 64)
        return launch<T, 64>(q, k, v, dout, lse, delta, tile_idx, tile_cnt, tile_order, dq, bh,
                             t, d, n_heads, block, max_slots, scale, causal, stream);
    return launch<T, 128>(q, k, v, dout, lse, delta, tile_idx, tile_cnt, tile_order, dq, bh, t,
                          d, n_heads, block, max_slots, scale, causal, stream);
}

}  // namespace wg

}  // namespace

// q, k, v, dout, dq: (bh, t, d) contiguous in `dtype`, d a multiple of 8 up to
// 128; lse, delta: (bh, t) f32. The head of row block i is i % n_heads. float32 walks the forward
// table idx (n_heads, t / block, max_n) and cnt (n_heads, t / block); bf16 and
// fp16 walk the tile tables of build_tile_tables (tiles of 64 q rows, the
// forward kernel's): tile_idx (n_heads, n_tiles, max_slots), tile_cnt
// (n_heads, n_tiles) and tile_order (n_heads * n_tiles), n_tiles = ceil(t /
// 64). All int32. Returns cudaGetLastError().
extern "C" int block_sparse_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   const void* idx, const void* cnt, const void* tile_idx,
                                   const void* tile_cnt, const void* tile_order, void* dq,
                                   int bh, int t, int d, int n_heads, int block, int max_n,
                                   int max_slots, float scale, int causal, int dtype,
                                   void* stream) {
    if (block_sparse::bad_args(bh, t, n_heads, block, max_n)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DS_F32)
        return (int)block_sparse::by_block<Dq, float>(block, d, q, k, v, dout, lse, delta, idx,
                                                      cnt, dq, bh, t, d, n_heads, max_n,
                                                      scale, causal, s);
    const int slots = 64 / (block < 64 ? block : 64);
    if ((dtype != DS_F16 && dtype != DS_BF16) || build_width(d, 128) == 0 ||
        (block != 16 && block != 32 && block != 64 && block != 128) || max_slots <= 0 ||
        max_slots % slots != 0 || tile_idx == nullptr || tile_cnt == nullptr ||
        tile_order == nullptr)
        return (int)cudaErrorInvalidValue;
    if (dtype == DS_F16)
        return (int)wg::dispatch<__half>(d, q, k, v, dout, lse, delta, tile_idx, tile_cnt,
                                         tile_order, dq, bh, t, n_heads, block, max_slots, scale,
                                         causal, s);
    return (int)wg::dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, tile_idx, tile_cnt,
                                            tile_order, dq, bh, t, n_heads, block, max_slots,
                                            scale, causal, s);
}
