// Block-sparse attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/block_sparse.py:_bwd_dkv_kernel
// (launched by the second pallas_call in _bs_bwd): dk and dv of block-sparse
// attention over q/k/v/do (b*h, t, d), walking for each k-block the q-blocks
// that attend to it (the transposed table; head i % n_heads) and recomputing
// the probabilities from the forward's f32 logsumexp; dk and dv stay in
// registers and are written once. dq is the other kernel's
// (csrc/block_sparse_bwd_dq.cu), so no block adds into another's output: no
// atomics, and the gradients are the same on every run.
//
// Masking is the forward's: a masked score is -1e30 and p = exp(s - lse), so
// a row with a valid key gives a masked entry p = 0, and a row whose walked
// entries are all masked (lse -1e30) gives each p = 1, as the TPU kernel
// does. Numerics follow the TPU kernel: f32 scores, p and ds (neither is
// rounded to the input dtype), f32 accumulators, dk and dv rounded to their
// dtype once.
//
// What bounds it on this card: per walked (row, col) pair 8*d operations (s =
// q.k, dp = do.v, dv += p.do, dk += ds.q) on 12*t*d bytes per (batch, head)
// plus lse, delta and the table: about 100 operations a byte on the training
// main path's layout (Fixed, block 16, t 1024), far below the ~295 bf16
// operations a byte where the tensor cores become the limit, so device-memory
// bytes bound it (0.068 ms at (24, 12, 1024, 64)).
//
// bf16 and fp16 (the kernel wgmma_bs_dkv below): the pipeline of wgmma_dkv
// (flash_bwd_dkv.cu) walking tile tables of the transposed layout, as
// wgmma_bs_fwd (block_sparse_fwd.cu) walks the forward's.
// - Tiles. The kernel works in units of U = min(block, 64) rows. A consumer
//   warpgroup owns 64 k rows: 64 / U k-units of one head (a 64-row slice of
//   one k-block at block 128), not necessarily consecutive, and walks the
//   UNION of the q-units that attend to any of them, in ascending order. The
//   table of ops/attention/block_sparse.py:build_bwd_tile_tables, built once
//   on the host, gives each tile's members, each entry's q-unit with a
//   bitmask of the members it attends to, and the launch order, longest walks
//   first. Under a Fixed layout at block 16 every later q-block attends to a
//   window's global column, so consecutive k-units would walk that column's
//   long list for all four; the table groups k-units by their walks instead
//   (846 64x64 stages a layout at the training shape against 1,632).
// - K and V of the members come in once by TMA, one box of U rows a member
//   into its place in a 64-row 128-byte-swizzled panel; a missing member's
//   slot (the last tile of a ragged t) holds member 0's rows, finite values
//   that are masked and never written (shared memory never written may hold
//   NaN, and 0 * NaN is NaN). A producer warp streams each stage's Q and dO
//   units by TMA through a ring of full/empty mbarrier stages, and their lse
//   (times log2 e) and delta by plain loads. A stage's last slots are padded
//   with a repeat of a real q-unit that no member owns. Maps are 3-D over (d,
//   t, b*h): a box never reads another head's rows.
// - S^T = K Q^T and dP^T = V dO^T are wgmma chains from shared memory; on the
//   f32 fragments P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta)
//   scale; then dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A
//   operands and dO and Q MN-major (the transpose bit), as in wgmma_dkv.
// - To keep the TPU kernel's f32 p and ds on 16-bit tensor cores, each is
//   split into hi (rounded to T) and lo (the rest, rounded to T), and both go
//   into the same f32 accumulator: 6 products a stage instead of 4, on a
//   kernel that bytes bound. Q and dO are exact in T, so each term keeps ~16
//   (bf16) or ~22 (fp16) bits, and no rounding flips at a halfway point.
// - Two masks, as in wgmma_bs_fwd, because the union walk shows a k row q
//   entries that the TPU kernel never walks for it: an entry whose member bit
//   is clear (or padding) scores -inf, so p = 0 and ds = 0 even on rows whose
//   lse is -1e30; a walked but causally masked one (col > row) the finite
//   -1e30 of _bwd_dkv_kernel, so a row whose walked entries are all masked
//   gets p = 1. A stage that every member owns wholly and that lies wholly at
//   or below the causal triangle skips both.
// - dk and dv are rounded once and each member's U rows written to their
//   place; a member no q-unit attends to, and a tile with an empty walk,
//   write zeros (the outputs are uninitialised).
// - One launch a call. The longest walks start first; they are not split
//   over blocks.
//
// float32 keeps the first version's kernel (block_sparse_bwd_dkv_kernel) on
// the CUDA cores, chosen by dtype alone as in K1, K3, K4 and K8: wgmma's only
// f32 input is TF32 (~10 mantissa bits), which would fail the f32 limits.
// That kernel: one block of 4*B threads a (b*h, k-block) walking its row of
// the transposed table, inputs widened to f32 in shared memory.

#include "hopper.cuh"
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

// ------------------------------------------------ bf16 / fp16: wgmma and TMA

namespace wg {

using namespace hopper;

template <int D>
struct Cfg {
    static constexpr int NP = D / PANEL;                   // 64-column panels of a row
    static constexpr int NST = D == 64 ? 3 : 2;            // stages of the Q/dO ring
    static constexpr int THREADS = 256;                    // a consumer, a producer
    static constexpr int KV_BYTES = 2 * NP * PANEL_BYTES;  // K panels, then V panels
    static constexpr int TILE_BYTES = 2 * NP * PANEL_BYTES;  // Q panels, then dO panels
    // lse and delta (2 x 64 f32) after the tiles, padded so stages stay 1024-aligned
    static constexpr int STAGE_BYTES = TILE_BYTES + 1024;
    static constexpr size_t SMEM = 1024 + KV_BYTES + NST * STAGE_BYTES + 8 * (1 + 2 * NST);
};

// One block: tile `order[blockIdx.x / n_batch]` = head * n_tiles + tile of
// batch blockIdx.x % n_batch. Units of 2^log2u rows; the tile's members are
// 64 >> log2u k-units (-1: none); an entry is q_unit << 8 | member bits (bit
// g: member g is attended by that q-unit); a tile's entries are padded to
// whole stages of 64 >> log2u. At d 64 two blocks share an SM, the producer
// handing its registers to the consumer.
template <typename T, int D>
__global__ void __launch_bounds__(256, D == 64 ? 2 : 1)
wgmma_bs_dkv(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const int* __restrict__ members, const int* __restrict__ tile_idx,
             const int* __restrict__ tile_cnt, const int* __restrict__ tile_order,
             T* __restrict__ dk, T* __restrict__ dv, int t, int n_heads, int n_batch,
             int n_tiles, int max_slots, int log2u, float scale, int causal) {
    using C = Cfg<D>;
    constexpr int NP = C::NP, NST = C::NST;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t k_s = (raw + 1023) & ~1023u;
    uint8_t* const gen = smem_raw + (k_s - raw);             // k_s as a generic pointer
    const uint32_t v_s = k_s + NP * PANEL_BYTES;
    const uint32_t ring = k_s + C::KV_BYTES;
    const uint32_t kv_full = ring + NST * C::STAGE_BYTES;    // then full[NST], empty[NST]
    auto full = [&](int s) { return kv_full + 8 * (1 + s); };
    auto empty = [&](int s) { return kv_full + 8 * (1 + NST + s); };
    // a stage's lse (log2 units) and delta, as generic pointers
    auto stage_rows = [&](int s) {
        return reinterpret_cast<float*>(gen + C::KV_BYTES + s * C::STAGE_BYTES + C::TILE_BYTES);
    };

    const int ht = tile_order[blockIdx.x / n_batch];
    const int head = ht / n_tiles;
    const int bh = (int)(blockIdx.x % n_batch) * n_heads + head;
    const int unit = 1 << log2u;
    const int slots = 64 >> log2u;                           // entries a stage, members a tile
    const int* ents = tile_idx + (size_t)ht * max_slots;
    const int* mem = members + (size_t)ht * slots;
    const int n_st = (tile_cnt[ht] + slots - 1) / slots;

    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < NST; ++s) {
            mbar_init(full(s), 32);
            mbar_init(empty(s), 128);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (threadIdx.x >= 128) {
        // producer: its first warp loads; lane 0 issues the TMA copies
        if constexpr (D == 64) setmaxnreg_dec<40>();
        if (threadIdx.x < 160) {
            const int lane = threadIdx.x - 128;
            if (lane == 0) {
                mbar_arrive_expect_tx(kv_full, C::KV_BYTES);
                for (int g = 0; g < slots; ++g) {
                    const int m = __ldg(mem + g);
                    const int k0 = (m >= 0 ? m : __ldg(mem)) * unit;
                    const uint32_t at = g * unit * 128;      // unit rows of 128 bytes
                    for (int p = 0; p < NP; ++p) {
                        tma_load_3d(k_s + at + p * PANEL_BYTES, &tm_k, kv_full, PANEL * p, k0, bh);
                        tma_load_3d(v_s + at + p * PANEL_BYTES, &tm_v, kv_full, PANEL * p, k0, bh);
                    }
                }
            }
            for (int st = 0; st < n_st; ++st) {
                const int s = st % NST;
                if (st >= NST) mbar_wait(empty(s), (st / NST - 1) & 1);
                float* rows = stage_rows(s);
                for (int r = lane; r < 64; r += 32) {
                    const int row = (__ldg(ents + st * slots + (r >> log2u)) >> 8) * unit +
                                    (r & (unit - 1));
                    rows[r] = lse[(size_t)bh * t + row] * LOG2E;
                    rows[64 + r] = delta[(size_t)bh * t + row];
                }
                if (lane == 0) {
                    mbar_arrive_expect_tx(full(s), C::TILE_BYTES);
                    const uint32_t base = ring + s * C::STAGE_BYTES;
                    for (int slot = 0; slot < slots; ++slot) {
                        const int q0 = (__ldg(ents + st * slots + slot) >> 8) * unit;
                        const uint32_t at = base + slot * unit * 128;
                        for (int p = 0; p < NP; ++p) {
                            tma_load_3d(at + p * PANEL_BYTES, &tm_q, full(s), PANEL * p, q0, bh);
                            tma_load_3d(at + (NP + p) * PANEL_BYTES, &tm_do, full(s), PANEL * p,
                                        q0, bh);
                        }
                    }
                } else {
                    mbar_arrive(full(s));
                }
            }
        }
    } else {
        // consumer warpgroup: the members' 64 k rows
        if constexpr (D == 64) setmaxnreg_inc<208>();
        const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
        const int g = (16 * warp) >> log2u;                  // the member of this thread's rows
        const int my_unit = __ldg(mem + g);
        // this thread's k rows (the keys' positions): ka, ka + 8
        const int ka = my_unit * unit + ((16 * warp + lane / 4) & (unit - 1));
        int max_member = 0;
        for (int i = 0; i < slots; ++i) max_member = max(max_member, __ldg(mem + i));
        const int wg_bits = (1 << slots) - 1;                // the tile's members
        const float sl2 = scale * LOG2E;                     // scores in log2 units
        const float excluded = __int_as_float((int)0xff800000);   // -inf: not the member's entry
        const float masked = DS_NEG_INF * LOG2E;             // -1e30, as lse * log2 e

        float dk_acc[NP][32], dv_acc[NP][32];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;

        mbar_wait(kv_full, 0);
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
            mbar_wait(full(s), (st / NST) & 1);
            const uint32_t qs = ring + s * C::STAGE_BYTES, dos = qs + NP * PANEL_BYTES;
            float sc[32], dp[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t off = (kk / 4) * PANEL_BYTES + 32 * (kk % 4);
                mma_ss<T, 0>(sc, desc(k_s + off), desc(qs + off), kk > 0);
                mma_ss<T, 0>(dp, desc(v_s + off), desc(dos + off), kk > 0);
            }
            wg_commit();
            wg_wait0();
            reg_fence(sc);
            reg_fence(dp);

            const float* rows = stage_rows(s);
            const bool need_mask = (all_own & wg_bits) != wg_bits ||
                                   (causal && (e[0] >> 8) <= max_member);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                // columns 8j .. 8j+7 of the stage lie in one entry
                const int slot = (8 * j) >> log2u;
                const int ej = slot == 0 ? e[0] : slot == 1 ? e[1] : slot == 2 ? e[2] : e[3];
                const bool own = (ej >> g) & 1;
                const int c0 = 8 * j + 2 * (lane % 4);
                const int row0 = (ej >> 8) * unit + (c0 & (unit - 1));
#pragma unroll
                for (int f = 0; f < 4; ++f) {
                    const int c = c0 + (f & 1);
                    float x = sc[4 * j + f] * sl2;
                    if (need_mask) {
                        // row: the query's position, col: the key's
                        const int row = row0 + (f & 1), col = ka + 8 * (f >> 1);
                        x = !own ? excluded : (causal && col > row) ? masked : x;
                    }
                    const float p = exp2f(x - rows[c]);
                    sc[4 * j + f] = p;
                    dp[4 * j + f] = p * (dp[4 * j + f] - rows[64 + c]) * scale;
                }
            }
            uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
            acc_to_afrag_split<T>(sc, p_hi, p_lo);
            acc_to_afrag_split<T>(dp, ds_hi, ds_lo);
            wg_fence();
#pragma unroll
            for (int p = 0; p < NP; ++p)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const uint64_t bdo = desc(dos + p * PANEL_BYTES + 2048 * kk);
                    const uint64_t bq = desc(qs + p * PANEL_BYTES + 2048 * kk);
                    mma_rs<T, 1>(dv_acc[p], p_hi[kk], bdo);
                    mma_rs<T, 1>(dv_acc[p], p_lo[kk], bdo);
                    mma_rs<T, 1>(dk_acc[p], ds_hi[kk], bq);
                    mma_rs<T, 1>(dk_acc[p], ds_lo[kk], bq);
                }
            wg_commit();
            wg_wait0();
#pragma unroll
            for (int p = 0; p < NP; ++p) {
                reg_fence(dv_acc[p]);
                reg_fence(dk_acc[p]);
            }
            mbar_arrive(empty(s));
        }

        if (my_unit >= 0) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const size_t off = ((size_t)bh * t + ka + 8 * i) * D;
#pragma unroll
                for (int p = 0; p < NP; ++p)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* members, const void* tile_idx,
                   const void* tile_cnt, const void* tile_order, void* dk, void* dv, int bh,
                   int t, int n_heads, int block, int max_slots, float scale, int causal,
                   cudaStream_t stream) {
    using C = Cfg<D>;
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    const int unit = block < 64 ? block : 64;
    const int log2u = unit == 16 ? 4 : unit == 32 ? 5 : 6;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err;
    if ((err = make_map_3d(&mq, q, bh, t, D, bf16, unit)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mk, k, bh, t, D, bf16, unit)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mv, v, bh, t, D, bf16, unit)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mdo, dout, bh, t, D, bf16, unit)) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(wgmma_bs_dkv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
    if (err != cudaSuccess) return err;
    const int n_tiles = (t + 63) / 64;
    wgmma_bs_dkv<T, D><<<bh * n_tiles, C::THREADS, C::SMEM, stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const int*>(members), static_cast<const int*>(tile_idx),
        static_cast<const int*>(tile_cnt), static_cast<const int*>(tile_order),
        static_cast<T*>(dk), static_cast<T*>(dv), t, n_heads, bh / n_heads, n_tiles, max_slots,
        log2u, scale, causal);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* members,
                     const void* tile_idx, const void* tile_cnt, const void* tile_order,
                     void* dk, void* dv, int bh, int t, int n_heads, int block, int max_slots,
                     float scale, int causal, cudaStream_t stream) {
    if (d == 64)
        return launch<T, 64>(q, k, v, dout, lse, delta, members, tile_idx, tile_cnt, tile_order,
                             dk, dv, bh, t, n_heads, block, max_slots, scale, causal, stream);
    return launch<T, 128>(q, k, v, dout, lse, delta, members, tile_idx, tile_cnt, tile_order, dk,
                          dv, bh, t, n_heads, block, max_slots, scale, causal, stream);
}

}  // namespace wg

}  // namespace

// q, k, v, dout, dk, dv: (bh, t, d) contiguous in `dtype`; lse, delta: (bh, t)
// f32. The head of row block i is i % n_heads. float32 walks the transposed
// table idx (n_heads, t / block, max_n) and cnt (n_heads, t / block); bf16
// and fp16 walk the tile tables of build_bwd_tile_tables (tiles of 64 k rows):
// members (n_heads, n_tiles, 64 / min(block, 64)), tile_idx (n_heads, n_tiles,
// max_slots), tile_cnt (n_heads, n_tiles) and tile_order (n_heads * n_tiles),
// n_tiles = ceil(t / 64). All int32. Returns cudaGetLastError().
extern "C" int block_sparse_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* idx, const void* cnt, const void* members,
                                    const void* tile_idx, const void* tile_cnt,
                                    const void* tile_order, void* dk, void* dv, int bh, int t,
                                    int d, int n_heads, int block, int max_n, int max_slots,
                                    float scale, int causal, int dtype, void* stream) {
    if (block_sparse::bad_args(bh, t, n_heads, block, max_n)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DS_F32)
        return (int)block_sparse::by_block<Dkv, float>(block, d, q, k, v, dout, lse, delta, idx,
                                                       cnt, dk, dv, bh, t, n_heads, max_n, scale,
                                                       causal, s);
    const int slots = 64 / (block < 64 ? block : 64);
    if ((dtype != DS_F16 && dtype != DS_BF16) || (d != 64 && d != 128) ||
        (block != 16 && block != 32 && block != 64 && block != 128) || max_slots <= 0 ||
        max_slots % slots != 0 || members == nullptr || tile_idx == nullptr ||
        tile_cnt == nullptr || tile_order == nullptr)
        return (int)cudaErrorInvalidValue;
    if (dtype == DS_F16)
        return (int)wg::dispatch<__half>(d, q, k, v, dout, lse, delta, members, tile_idx,
                                         tile_cnt, tile_order, dk, dv, bh, t, n_heads, block,
                                         max_slots, scale, causal, s);
    return (int)wg::dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, members, tile_idx,
                                            tile_cnt, tile_order, dk, dv, bh, t, n_heads, block,
                                            max_slots, scale, causal, s);
}
