// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/flash.py:_fwd_kernel
// (launched by the pallas_call in _flash_fwd): causal or full attention over
// q/k/v (b*h, t, d) with an online softmax, an optional ALiBi bias
// slope[h] * (col - row), and the f32 logsumexp that the backward reuses. The
// (t x t) score matrix never reaches device memory.
//
// What bounds it on this card: causal attention does 4*d operations a causal
// (row, col) pair on 8*t*d bytes (q, k, v in, o out) per (batch, head), about
// t/4 operations a byte. At the serving prefill's t = 512 that is 128, below
// the ~295 bf16 operations a byte where the H100's tensor cores become the
// limit, so device-memory bytes bound it; from t of about 1200 up, the
// operations do. Either bound is out of reach of the CUDA cores: at the
// training shape the products alone take 0.58 ms at their 67 TFLOP/s.
//
// bf16 and fp16 (the kernel wgmma_fwd below) run both products on the tensor
// cores, as the TPU kernel runs them on its MXU: 16-bit inputs, f32 sums.
// - A block owns 64 q rows per consumer warpgroup (one or two, picked by
//   shape in fwd_warpgroups) of one (b*h), plus one producer warpgroup.
// - The producer's first thread loads the q tile once by TMA, then streams
//   64-row K and V tiles by TMA through a ring of stages, each with a full and
//   an empty mbarrier; with two consumer warpgroups at d 64, setmaxnreg
//   moves the producer's registers to the consumers.
// - S = Q K^T is one wgmma chain from shared memory (K's rows are K-major for
//   the B operand). The online softmax runs on the f32 accumulator fragments
//   in registers; a row's max and sum are reduced across the four lanes that
//   share it. The scale, ALiBi bias and -1e30 mask are applied as in
//   _fwd_kernel, the mask only on tiles that meet the diagonal or t.
// - P is rounded to the input dtype in registers (the TPU kernel's rounding,
//   flash.py:141) and is the register A operand of O += P V, V being the
//   MN-major B operand (the transpose bit), so P never touches shared memory.
// - The epilogue divides by l (a row with l == 0 by 1) and writes o and the
//   f32 lse = m + log l. Under `causal` a block stops at its diagonal tile, a
//   warpgroup skips tiles wholly right of its rows, and blocks start with
//   the longest q tiles so the triangle's short tail fills the last wave.
// - Tiles are 3-D TMA boxes of (d, t, b*h), so a box past t is zero-filled
//   and never reads the next head's rows; o is stored row by row up to t.
//
// Head dims: both kernels are built for a row width D of 64, 128 and 256
// (D 256 serves GPT-J-class prefill; the backward kernels stop at 128) and
// take the real head_dim d, a multiple of 8 up to D, at run time (common.cuh:
// build_width). The TMA maps are d wide, so a 64-column panel past d comes
// in zero-filled and adds nothing; rows lie d apart in device memory, and the
// stores stop at column d. d 80 and 96 do 1.6x and 1.33x the products they
// need on the 128-wide build. At D 256 a block has one consumer warpgroup
// (O is 128 f32 registers a thread; q and two K/V stages take 160 KB), and
// the f32 kernel loads each K/V tile when its turn comes (prefetched
// registers would spill). A head_dim equal to its width runs a second
// instantiation (EXACT) in which d is the constant D: the code d 64 and 128
// ran before, whose times the run-time stride and guards would cost 5 %.
//
// float32 keeps the first version's kernel (flash_fwd_kernel) on the CUDA
// cores: wgmma's only f32 input type is TF32, which keeps ~10 mantissa bits,
// while the TPU kernel takes f32 products in full f32. The choice between the
// two is by dtype alone.
//
// First version's layout (float32; 256 threads, one 64-row q tile of one
// (batch, head)): thread (ty, tx) = (tid / 16, tid % 16) owns rows 4*ty ..
// 4*ty+3 of the tile; of each 64-column score tile it computes columns
// tx + 16*j, and of the output columns tx + 16*c. The 16 threads of a row
// group sit in one half warp, so row maxima and sums are shuffles. Numerics
// of both kernels follow the TPU kernel: scores in f32, masked entries set to
// -1e30, P rounded to the input dtype before the PV product, f32 accumulator,
// a row with l == 0 divided by 1. Rows and columns past t are masked, so any
// t works.

#include "hopper.cuh"
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
                 float* __restrict__ lse, int t, int d, int n_heads, float scale,
                 int causal) {
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
    const size_t base = (size_t)bh * t * d;
    const bool use_alibi = slopes != nullptr;
    const float slope = use_alibi ? slopes[bh % n_heads] : 0.f;

    // tiles move as 16-byte vectors, rows d apart in device memory, columns
    // d .. D-1 zero; up to D 128, K/V of the next tile are fetched into
    // registers while the current tile computes (at D 256 those registers
    // would spill, so each tile is loaded when its turn comes)
    constexpr int VEC = vec_elems<T>();
    constexpr int ROW_VECS = D / VEC;
    constexpr int PER_THREAD = BK * ROW_VECS / NTHREADS;
    constexpr bool PREFETCH = D <= 128;
    static_assert(BK * ROW_VECS % NTHREADS == 0 && BQ == BK, "tiles must split evenly");
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const int vi = tid + i * NTHREADS;
        const int r = vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
        const int row = q0 + r;
        const uint4 raw = row < t && c < d ? load16(q + base + (size_t)row * d + c)
                                           : make_uint4(0u, 0u, 0u, 0u);
        store16_f32<T>(qs + r * DP + c, raw);
    }
    uint4 kreg[PREFETCH ? PER_THREAD : 1], vreg[PREFETCH ? PER_THREAD : 1];
    auto fetch = [&](int k0) {
        if constexpr (PREFETCH) {
#pragma unroll
            for (int i = 0; i < PER_THREAD; ++i) {
                const int vi = tid + i * NTHREADS;
                const int row = k0 + vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
                const size_t idx = base + (size_t)row * d + c;
                const bool ok = row < t && c < d;
                kreg[i] = ok ? load16(k + idx) : make_uint4(0u, 0u, 0u, 0u);
                vreg[i] = ok ? load16(v + idx) : make_uint4(0u, 0u, 0u, 0u);
            }
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

    if constexpr (PREFETCH) fetch(0);
    for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                // the previous tile's k/v/P reads are done
        if constexpr (PREFETCH) {
#pragma unroll
            for (int i = 0; i < PER_THREAD; ++i) {
                const int vi = tid + i * NTHREADS;
                const int r = vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
                store16_f32<T>(ks + r * DP + c, kreg[i]);
                store16_f32<T>(vs + r * D + c, vreg[i]);
            }
            if (kt + 1 < nk) fetch(k0 + BK);
        } else {
#pragma unroll 4
            for (int i = 0; i < PER_THREAD; ++i) {
                const int vi = tid + i * NTHREADS;
                const int r = vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
                const size_t idx = base + (size_t)(k0 + r) * d + c;
                const bool ok = k0 + r < t && c < d;
                const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
                store16_f32<T>(ks + r * DP + c, ok ? load16(k + idx) : zero);
                store16_f32<T>(vs + r * D + c, ok ? load16(v + idx) : zero);
            }
        }
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
            const size_t off = base + (size_t)row * d;
#pragma unroll
            for (int c = 0; c < DC; ++c)
                if (tx + 16 * c < d) o[off + tx + 16 * c] = from_f32<T>(acc[i][c] / l_safe);
            if (tx == 0) lse[(size_t)bh * t + row] = m[i] + logf(l_safe);
        }
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* slopes, void* o,
                   void* lse, int bh, int t, int d, int n_heads, float scale, int causal,
                   cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((t + BQ - 1) / BQ, bh);
    flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(slopes), static_cast<T*>(o), static_cast<float*>(lse), t, d,
        n_heads, scale, causal);
    return cudaGetLastError();
}

// ------------------------------------------------ bf16 / fp16: wgmma and TMA

namespace wg {

using namespace hopper;

constexpr int BK = 64;          // k/v rows per tile

// D 256 (serving only) runs one consumer warpgroup: its O accumulator is
// 128 f32 registers a thread beside S and P, and q plus two K/V stages take
// 160 KB of shared memory, so one block fills an SM
template <int D, int NWG>
struct Cfg {
    static_assert(D != 256 || NWG == 1, "D 256 runs one consumer warpgroup");
    static constexpr int NP = D / PANEL;                      // 64-column panels of a row
    static constexpr int NST = D == 64 ? 3 : 2;               // stages of the K/V ring
    static constexpr int THREADS = 128 * (NWG + 1);
    static constexpr int Q_BYTES = NWG * NP * PANEL_BYTES;
    static constexpr int STAGE_BYTES = 2 * NP * PANEL_BYTES;  // K panels, then V panels
    // 1024 bytes of slack to align the tiles, then q, the ring, the barriers
    static constexpr size_t SMEM = 1024 + Q_BYTES + NST * STAGE_BYTES + 8 * (1 + 2 * NST);
};

template <typename T, int D, int NWG, bool EXACT>
__global__ void __launch_bounds__(128 * (NWG + 1), (NWG == 1 && D == 64) ? 2 : 1)
wgmma_fwd(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ slopes,
          T* __restrict__ o, float* __restrict__ lse, int t, int d, int n_heads, float scale,
          int causal) {
    using C = Cfg<D, NWG>;
    constexpr int NP = C::NP, NST = C::NST;
    // the exact build (d == D) folds the strides and guards below to constants
    if constexpr (EXACT) d = D;

    // setmaxnreg where it paid in the sweep: d 64 with two consumer warpgroups
    // (3 % at the training shape); at d 128 it cost 5 %
    constexpr bool REBALANCE = NWG == 2 && D == 64;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
    const uint32_t ring = q_s + C::Q_BYTES;
    const uint32_t q_full = ring + NST * C::STAGE_BYTES;     // then full[NST], empty[NST]
    auto full = [&](int s) { return q_full + 8 * (1 + s); };
    auto empty = [&](int s) { return q_full + 8 * (1 + NST + s); };

    const int bh = blockIdx.x;
    const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;   // longest first
    const int q0 = tile * 64 * NWG;
    int nk = (t + BK - 1) / BK;
    if (causal) nk = min(nk, (q0 + 64 * NWG - 1) / BK + 1);   // stop at the diagonal tile

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < NST; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 128 * NWG);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wgi = threadIdx.x / 128;
    if (wgi == NWG) {
        // producer: one thread issues every load
        if constexpr (REBALANCE) setmaxnreg_dec<40>();
        if (threadIdx.x == 128 * NWG) {
            mbar_arrive_expect_tx(q_full, C::Q_BYTES);
            for (int w = 0; w < NWG; ++w)
                for (int p = 0; p < NP; ++p)
                    tma_load_3d(q_s + (w * NP + p) * PANEL_BYTES, &tm_q, q_full, PANEL * p,
                                q0 + 64 * w, bh);
            for (int kt = 0; kt < nk; ++kt) {
                const int s = kt % NST;
                if (kt >= NST) mbar_wait(empty(s), (kt / NST - 1) & 1);
                mbar_arrive_expect_tx(full(s), C::STAGE_BYTES);
                const uint32_t st = ring + s * C::STAGE_BYTES;
                for (int p = 0; p < NP; ++p) {
                    tma_load_3d(st + p * PANEL_BYTES, &tm_k, full(s), PANEL * p, kt * BK, bh);
                    tma_load_3d(st + (NP + p) * PANEL_BYTES, &tm_v, full(s), PANEL * p, kt * BK,
                                bh);
                }
            }
        }
    } else {
        // consumer warpgroup wgi: q rows row0 .. row0 + 63
        if constexpr (REBALANCE) setmaxnreg_inc<232>();
        const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
        const int row0 = q0 + 64 * wgi;
        const int ra = row0 + 16 * warp + lane / 4;          // this thread's rows: ra, ra + 8
        const float sl2 = scale * LOG2E;                     // scores in log2 units
        const float slope2 = slopes != nullptr ? slopes[bh % n_heads] * LOG2E : 0.f;
        const uint32_t qw = q_s + wgi * NP * PANEL_BYTES;

        float acc[NP][32];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
        float m[2] = {DS_NEG_INF, DS_NEG_INF}, l[2] = {0.f, 0.f};

        mbar_wait(q_full, 0);
        for (int kt = 0; kt < nk; ++kt) {
            const int s = kt % NST;
            const int k0 = kt * BK;
            mbar_wait(full(s), (kt / NST) & 1);
            if (!causal || k0 <= row0 + 63) {
                const uint32_t ks = ring + s * C::STAGE_BYTES, vs = ks + NP * PANEL_BYTES;
                float sc[32];
#pragma unroll
                for (int i = 0; i < 32; ++i) sc[i] = 0.f;
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const uint32_t off = (kk / 4) * PANEL_BYTES + 32 * (kk % 4);
                    mma_ss<T, 0>(sc, desc(qw + off), desc(ks + off), kk > 0);
                }
                wg_commit();
                wg_wait0();
                reg_fence(sc);

                const bool need_mask = (causal && k0 + BK - 1 > row0) || k0 + BK > t;
                float mx[2] = {DS_NEG_INF, DS_NEG_INF};
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
                        const int row = ra + 8 * (e >> 1);
                        float x = sc[4 * j + e] * sl2;
                        if (slopes != nullptr) x += slope2 * (float)(col - row);
                        if (need_mask && (col >= t || (causal && col > row))) x = DS_NEG_INF;
                        sc[4 * j + e] = x;
                        mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
                T* orow = o + ((size_t)bh * t + row) * d;
#pragma unroll
                for (int p = 0; p < NP; ++p)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        if (PANEL * p + 8 * j >= d) continue;     // d is a multiple of 8
                        const float lo = acc[p][4 * j + 2 * i] / l_safe;
                        const float hi = acc[p][4 * j + 2 * i + 1] / l_safe;
                        *reinterpret_cast<uint32_t*>(orow + PANEL * p + 8 * j + 2 * (lane % 4)) =
                            pack2<T>(lo, hi);
                    }
                if (lane % 4 == 0) lse[(size_t)bh * t + row] = m[i] * LN2 + logf(l_safe);
            }
        }
    }
}

// consumer warpgroups a block: two (128 q rows) where that leaves at least two
// blocks an SM, else one (64 rows, two blocks an SM at d 64), from the sweep in
// benchmarks/torch/qmm_versions.py; DS_FLASH_FWD_WG=1|2 at build time
// forces one, for that sweep
inline int fwd_warpgroups(int bh, int t) {
#ifdef DS_FLASH_FWD_WG
    return DS_FLASH_FWD_WG;
#else
    return (long long)bh * ((t + 127) / 128) >= 2 * 132 ? 2 : 1;
#endif
}

template <typename T, int D, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, const void* slopes, void* o,
                   void* lse, int bh, int t, int d, int n_heads, float scale, int causal,
                   cudaStream_t stream) {
    using C = Cfg<D, NWG>;
    constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    CUtensorMap mq, mk, mv;
    cudaError_t err;
    // maps d wide: a panel's columns past d are zero-filled by the TMA unit
    // (and still counted in the barrier's bytes), so they add nothing to
    // Q K^T and give zero columns of P V, which the epilogue does not store
    if ((err = make_map_3d(&mq, q, bh, t, d, bf16)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mk, k, bh, t, d, bf16)) != cudaSuccess) return err;
    if ((err = make_map_3d(&mv, v, bh, t, d, bf16)) != cudaSuccess) return err;
    auto* kernel = d == D ? wgmma_fwd<T, D, NWG, true> : wgmma_fwd<T, D, NWG, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid(bh, (t + 64 * NWG - 1) / (64 * NWG));
    kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
        mq, mk, mv, static_cast<const float*>(slopes), static_cast<T*>(o),
        static_cast<float*>(lse), t, d, n_heads, scale, causal);
    return cudaGetLastError();
}

}  // namespace wg

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* slopes, void* o,
                       void* lse, int bh, int t, int d, int n_heads, float scale, int causal,
                       cudaStream_t stream) {
    const int width = build_width(d, 256);
    if constexpr (std::is_same<T, float>::value) {
        if (width == 64)
            return launch<T, 64>(q, k, v, slopes, o, lse, bh, t, d, n_heads, scale, causal,
                                 stream);
        if (width == 128)
            return launch<T, 128>(q, k, v, slopes, o, lse, bh, t, d, n_heads, scale, causal,
                                  stream);
        if (width == 256)
            return launch<T, 256>(q, k, v, slopes, o, lse, bh, t, d, n_heads, scale, causal,
                                  stream);
    } else {
        const bool two = wg::fwd_warpgroups(bh, t) == 2;
        if (width == 64)
            return two ? wg::launch<T, 64, 2>(q, k, v, slopes, o, lse, bh, t, d, n_heads, scale,
                                              causal, stream)
                       : wg::launch<T, 64, 1>(q, k, v, slopes, o, lse, bh, t, d, n_heads, scale,
                                              causal, stream);
        if (width == 128)
            return two ? wg::launch<T, 128, 2>(q, k, v, slopes, o, lse, bh, t, d, n_heads,
                                               scale, causal, stream)
                       : wg::launch<T, 128, 1>(q, k, v, slopes, o, lse, bh, t, d, n_heads,
                                               scale, causal, stream);
        if (width == 256)
            return wg::launch<T, 256, 1>(q, k, v, slopes, o, lse, bh, t, d, n_heads, scale,
                                         causal, stream);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: (bh, t, d) contiguous in `dtype`, d a multiple of 8 up to 256;
// slopes: (n_heads,) f32 or null, head of row block i is i % n_heads; lse:
// (bh, t) f32. Returns cudaGetLastError().
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
