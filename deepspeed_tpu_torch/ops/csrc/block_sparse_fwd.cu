// Block-sparse attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/block_sparse.py:_fwd_kernel
// (launched by the pallas_call in _bs_fwd): attention of q/k/v (b*h, t, d)
// over only the active blocks of a (H, nb, nb) block layout (head i % n_heads
// of row block i), with an online softmax in ascending k order; under
// `causal` the triangle applies inside the blocks. Returns o and the f32
// logsumexp that the backward kernels (block_sparse_bwd_dq.cu,
// block_sparse_bwd_dkv.cu) reuse.
//
// What bounds it on this card: per walked (row, col) pair 4*d operations (s =
// q.k, o += p.v) on 8*t*d bytes per (batch, head) plus the table. The
// training main path's layout (Fixed, block 16, 4 local blocks, 1 global, 4
// patterns, t 1024) holds 156,160 causal pairs a head: about 76 operations a
// byte, far below the ~295 bf16 operations a byte where the tensor cores
// become the limit, so device-memory bytes bound it (0.045 ms at (24, 12,
// 1024, 64) at the H100's 3.35 TB/s). The work that reaches it is the tensor
// cores' and TMA's: one k-block read once per tile of rows that needs it,
// products at wgmma rate.
//
// bf16 and fp16 (the kernel wgmma_bs_fwd below): the pipeline of wgmma_fwd
// (flash_fwd.cu) walking a table instead of a loop.
// - Tiles. The kernel works in units of U = min(block, 64) rows. A consumer
//   warpgroup owns 64 q rows: 64 / U consecutive q-blocks (4 at block 16, 2
//   at 32), or a 64-row slice of one q-block at block 64 and 128. A block
//   runs one consumer warpgroup and one producer warpgroup (two consumers
//   sharing one ring, a union over 128 rows, were slower at every check case;
//   see PERF.md's K8 findings), and walks the UNION of its rows' k-units in
//   ascending order: the tile table of
//   ops/attention/block_sparse.py:build_tile_tables, built once on the host,
//   gives each entry's k-unit and a bitmask of the tile's q-units that own
//   it, and launches the longest walks first.
// - A stage is 64 columns: 64 / U entries. The producer's first thread loads
//   each entry's K and V rows as one TMA box of U rows into its place in a
//   64-row 128-byte-swizzled panel (a box of 16 rows is 2 KB, so each lands on
//   a swizzle boundary), through a ring of full/empty mbarrier stages. A
//   tile's last stage is padded with a repeat of a real entry that no row
//   owns: every slot is loaded, since shared memory never written may hold a
//   NaN and 0 * NaN is NaN in P V.
// - S = Q K^T is an mma_ss chain with q resident (loaded once by TMA); P is
//   rounded to the input dtype in registers and is the register A operand of
//   O += P V (V MN-major, the transpose bit), as in wgmma_fwd.
// - Two masks on the f32 score fragments, because a union walk shows a row
//   entries that the TPU kernel never walks for it:
//   1. not the row's own block (its q-unit's bit clear, or padding): p = 0,
//      and the entry takes no part in the row's max: the score is -inf, so m,
//      l and acc stay exactly as they were, as if it were not walked;
//   2. walked but causally masked (col > row): the finite -1e30 of
//      _fwd_kernel, whose running max starts at -1e30 too. So a row whose
//      walked entries are all masked gets p = 1 on each of them, the mean of
//      those V rows and an lse of -1e30; a row that walks nothing gets o = 0
//      and an lse of -1e30. Treating (2) as (1) would zero such rows; treating
//      (1) as (2) would give a row real attention to blocks below its
//      diagonal that it does not own.
//   Taking the max over a 64-column stage at once is the same function:
//   excluded entries never move m, and masked entries of a row with a valid
//   key give exp(-1e30 - m) = 0 in either order. A stage whose every entry
//   every row of the warpgroup owns, and that lies wholly at or below its
//   first row, skips both masks; a stage no row of the warpgroup owns is
//   skipped.
// - The epilogue divides by l (a row with l == 0 by 1), writes o in T and
//   the lse for rows < t. Maps are 3-D over (d, t, b*h), so a q box past t is
//   zero-filled; those rows own nothing and are not written.
//
// float32 keeps the first version's kernel (block_sparse_fwd_kernel) on the
// CUDA cores, chosen by dtype alone as in K1, K3 and K4: wgmma's only f32
// input is TF32 (~10 mantissa bits), which would fail the f32 limits, while
// the TPU kernel takes f32 products in full f32. That kernel: one block of
// 4*B threads a (b*h, q-block) walking its row of the forward table, inputs
// widened to f32 in shared memory, f32 p (not rounded) in the product with v.

#include "hopper.cuh"
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

// ------------------------------------------------ bf16 / fp16: wgmma and TMA

namespace wg {

using namespace hopper;

template <int D>
struct Cfg {
    static constexpr int NP = D / PANEL;                      // 64-column panels of a row
    static constexpr int NST = D == 64 ? 3 : 2;               // stages of the K/V ring
    static constexpr int THREADS = 256;                       // a consumer, a producer
    static constexpr int Q_BYTES = NP * PANEL_BYTES;
    static constexpr int STAGE_BYTES = 2 * NP * PANEL_BYTES;  // K panels, then V panels
    // 1024 bytes of slack to align the tiles, then q, the ring, the barriers
    static constexpr size_t SMEM = 1024 + Q_BYTES + NST * STAGE_BYTES + 8 * (1 + 2 * NST);
};

// One block: tile `order[blockIdx.x / n_batch]` = head * n_tiles + tile of
// batch blockIdx.x % n_batch; 64 q rows from tile * 64. Units of
// 2^log2u rows; an entry is k_unit << 8 | owner bits (bit g: the tile's q-unit
// g owns it); a tile's entries are padded to whole stages of 64 >> log2u.
template <typename T, int D>
__global__ void __launch_bounds__(256, D == 64 ? 2 : 1)
wgmma_bs_fwd(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ tile_idx,
             const int* __restrict__ tile_cnt, const int* __restrict__ tile_order,
             T* __restrict__ o, float* __restrict__ lse, int t, int n_heads, int n_batch,
             int n_tiles, int max_slots, int log2u, float scale, int causal) {
    using C = Cfg<D>;
    constexpr int NP = C::NP, NST = C::NST;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
    const uint32_t ring = q_s + C::Q_BYTES;
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
            mbar_arrive_expect_tx(q_full, C::Q_BYTES);
            for (int p = 0; p < NP; ++p)
                tma_load_3d(q_s + p * PANEL_BYTES, &tm_q, q_full, PANEL * p, q0, bh);
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

        float acc[NP][32];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
        float m[2] = {DS_NEG_INF, DS_NEG_INF}, l[2] = {0.f, 0.f};

        mbar_wait(q_full, 0);
        for (int st = 0; st < n_st; ++st) {
            const int s = st % NST;
            // the stage's entries (slots beyond `slots` repeat the first)
            int e[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) e[i] = __ldg(ents + st * slots + (i < slots ? i : 0));
            int all_own = 0xFF, any_own = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (i < slots) {
                    all_own &= e[i];
                    any_own |= e[i];
                }
            const int e_last = slots == 1 ? e[0] : slots == 2 ? e[1] : e[3];
            mbar_wait(full(s), (st / NST) & 1);
            if (any_own & wg_bits) {
                const uint32_t ks = ring + s * C::STAGE_BYTES, vs = ks + NP * PANEL_BYTES;
                float sc[32];
#pragma unroll
                for (int i = 0; i < 32; ++i) sc[i] = 0.f;
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const uint32_t off = (kk / 4) * PANEL_BYTES + 32 * (kk % 4);
                    mma_ss<T, 0>(sc, desc(q_s + off), desc(ks + off), kk > 0);
                }
                wg_commit();
                wg_wait0();
                reg_fence(sc);

                const bool need_mask = (all_own & wg_bits) != wg_bits ||
                                       (causal && ((e_last >> 8) + 1) * unit - 1 > q0);
                float mx[2] = {DS_NEG_INF, DS_NEG_INF};
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
                            x = !own ? excluded : (causal && col > row) ? DS_NEG_INF : x;
                        }
                        sc[4 * j + f] = x;
                        mx[f >> 1] = fmaxf(mx[f >> 1], x);
                    }
                }
                float alpha[2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                    const float m_new = fmaxf(m[i], mx[i]);
                    alpha[i] = exp2f(m[i] - m_new);
                    m[i] = m_new;
                    l[i] *= alpha[i];
                }
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                    const float p = exp2f(sc[i] - m[(i >> 1) & 1]);
                    l[(i >> 1) & 1] += p;          // this thread's share of the row sum
                    sc[i] = p;
                }
                uint32_t pa[4][4];
                acc_to_afrag<T>(sc, pa);           // P rounded to T
#pragma unroll
                for (int p = 0; p < NP; ++p)
#pragma unroll
                    for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i >> 1) & 1];
                wg_fence();
#pragma unroll
                for (int p = 0; p < NP; ++p)
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
                        mma_rs<T, 1>(acc[p], pa[kk], desc(vs + p * PANEL_BYTES + 2048 * kk));
                wg_commit();
                wg_wait0();
#pragma unroll
                for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
            }
            mbar_arrive(empty(s));
        }

#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
            const int row = ra + 8 * i;
            if (row < t) {
                const float l_safe = l[i] > 0.f ? l[i] : 1.f;
                T* orow = o + ((size_t)bh * t + row) * D;
#pragma unroll
                for (int p = 0; p < NP; ++p)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const float lo = acc[p][4 * j + 2 * i] / l_safe;
                        const float hi = acc[p][4 * j + 2 * i + 1] / l_safe;
                        *reinterpret_cast<uint32_t*>(orow + PANEL * p + 8 * j + 2 * (lane % 4)) =
                            pack2<T>(lo, hi);
                    }
                // -1e30 where nothing was walked or every walked entry was masked
                // (m is then -1e30 exactly, and -1e30 + log l rounds to -1e30)
                if (lane % 4 == 0)
                    lse[(size_t)bh * t + row] =
                        l[i] > 0.f && m[i] > DS_NEG_INF ? m[i] * LN2 + logf(l[i]) : DS_NEG_INF;
            }
        }
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tile_idx,
                   const void* tile_cnt, const void* tile_order, void* o, void* lse, int bh,
                   int t, int n_heads, int block, int max_slots, float scale, int causal,
                   cudaStream_t stream) {
    using C = Cfg<D>;
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    const int unit = block < 64 ? block : 64;
    const int log2u = unit == 16 ? 4 : unit == 32 ? 5 : 6;
    CUtensorMap mq, mk, mv;
    cudaError_t err;
    if ((err = make_map_3d(&mq, q, bh, t, D, bf16)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mk, k, bh, t, D, bf16, unit)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mv, v, bh, t, D, bf16, unit)) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(wgmma_bs_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
    if (err != cudaSuccess) return err;
    const int n_tiles = (t + 63) / 64;
    wgmma_bs_fwd<T, D><<<bh * n_tiles, C::THREADS, C::SMEM, stream>>>(
        mq, mk, mv, static_cast<const int*>(tile_idx), static_cast<const int*>(tile_cnt),
        static_cast<const int*>(tile_order), static_cast<T*>(o), static_cast<float*>(lse), t,
        n_heads, bh / n_heads, n_tiles, max_slots, log2u, scale, causal);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* tile_idx,
                     const void* tile_cnt, const void* tile_order, void* o, void* lse, int bh,
                     int t, int n_heads, int block, int max_slots, float scale, int causal,
                     cudaStream_t stream) {
    if (d == 64)
        return launch<T, 64>(q, k, v, tile_idx, tile_cnt, tile_order, o, lse, bh, t, n_heads,
                             block, max_slots, scale, causal, stream);
    return launch<T, 128>(q, k, v, tile_idx, tile_cnt, tile_order, o, lse, bh, t, n_heads,
                          block, max_slots, scale, causal, stream);
}

}  // namespace wg

}  // namespace

// q, k, v, o: (bh, t, d) contiguous in `dtype`; lse: (bh, t) f32. The head of
// row block i is i % n_heads. float32 walks the forward table idx (n_heads,
// t / block, max_n) and cnt (n_heads, t / block); bf16 and fp16 walk the tile
// tables of build_tile_tables (tiles of 64 q rows): tile_idx (n_heads, n_tiles,
// max_slots), tile_cnt (n_heads, n_tiles) and tile_order (n_heads * n_tiles),
// n_tiles = ceil(t / 64). All int32. Returns cudaGetLastError().
extern "C" int block_sparse_fwd(const void* q, const void* k, const void* v, const void* idx,
                                const void* cnt, const void* tile_idx, const void* tile_cnt,
                                const void* tile_order, void* o, void* lse, int bh, int t,
                                int d, int n_heads, int block, int max_n, int max_slots,
                                float scale, int causal, int dtype, void* stream) {
    if (block_sparse::bad_args(bh, t, n_heads, block, max_n)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == DS_F32)
        return (int)block_sparse::by_block<Fwd, float>(block, d, q, k, v, idx, cnt, o, lse, bh,
                                                       t, n_heads, max_n, scale, causal, s);
    const int slots = 64 / (block < 64 ? block : 64);
    if ((dtype != DS_F16 && dtype != DS_BF16) || (d != 64 && d != 128) ||
        (block != 16 && block != 32 && block != 64 && block != 128) || max_slots <= 0 ||
        max_slots % slots != 0 || tile_idx == nullptr || tile_cnt == nullptr ||
        tile_order == nullptr)
        return (int)cudaErrorInvalidValue;
    if (dtype == DS_F16)
        return (int)wg::dispatch<__half>(d, q, k, v, tile_idx, tile_cnt, tile_order, o, lse, bh,
                                         t, n_heads, block, max_slots, scale, causal, s);
    return (int)wg::dispatch<__nv_bfloat16>(d, q, k, v, tile_idx, tile_cnt, tile_order, o, lse,
                                            bh, t, n_heads, block, max_slots, scale, causal, s);
}
