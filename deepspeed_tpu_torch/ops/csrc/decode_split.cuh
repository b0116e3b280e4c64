// The split decode body for Hopper (sm_90a): one decode step of the g query
// heads of one kv head, with that kv head's rows split over the S blocks of
// a thread-block cluster (S = 1, 2, 4 or 8), each block walking its share
// through a ring of shared-memory stages fed by bulk copies, and the S
// partial results merged once, in rank order, through distributed shared
// memory. The paged decode kernel (paged_decode_attention.cu) runs it over a
// page pool, the dense decode kernel (decode_attention.cu) over a head-major
// cache.
//
// The rows come in "units": a unit is a contiguous run of at most 64 rows
// that lies contiguously in k and in v (a page, or a 64-row piece of a page
// longer than 64 rows; a 64-row tile of a dense cache). The caller's `Units`
// says where each unit lives:
//   count      the units that hold the rows [0, len), in row order
//   per_stage  the units a stage holds (per_stage * unit_rows <= 64)
//   unit_rows  a unit's row stride in a stage; every unit of a stage but its
//              last has exactly unit_rows rows, so a stage's rows are one
//              contiguous run of the sequence
//   KEYED      whether locating a unit reads device memory (a static
//              constexpr bool); if so,
//   key(u)     what locating unit u reads (a page-table entry); read once,
//              by the producer warp, a window of stages at a time
//   offset(u, key), or offset(u) where KEYED is false: the element offset
//              of u's first row in k and v
//   first_row(u), rows(u)  u's first row in the sequence and its row count
//
// Block r of a cluster takes the units [r * share, (r + 1) * share) with
// share = cdiv(count, S), so every block of a pair carries the same number
// of rows whatever the sequence's length; a block whose range is empty
// contributes m = -inf, l = 0. Rows at or past len are masked; a sequence
// with len 0 gets zeros.
//
// What bounds it: every K/V element read feeds 2 g multiply-adds (g = 1 for
// GPT-2, 4 at GQA d 128), far below the ~295 operations a byte at which the
// H100's tensor cores rather than its memory would be the limit, so the
// kernel is bound by the bytes of the valid K/V rows, and a wgmma would carry
// 64 rows of q of which g are real. The gain is in bytes in flight and SMs
// busy, so it runs on the CUDA cores: the S blocks of a pair spread one
// sequence over S SMs, one producer thread a stage issues one bulk copy a
// unit for K and one for V (no tensor map, so no host-side encoding: the
// call costs a plain launch), and a ring of NST stages keeps up to 48-196 KB
// in flight a block (fewer stages at D 256, where one is 64 or 128 KB).
//
// Head dims: the body is built for a row width D of 64, 128 or 256 and
// takes the real head_dim d (a multiple of 8, at most D) at run time. Rows
// lie d apart in device memory and in a stage, so a unit is one bulk copy of
// rows x d elements (a multiple of 16 bytes); q and the output are g x d.
//
// Layout of a block: NCW consumer warps (4, or 8 at four heads; see Shape)
// and one producer warp. K/V stay in the input dtype in shared memory and
// widen to f32 in registers. Consumer warp w takes rows [w * 64 / NCW,
// (w + 1) * 64 / NCW) of each stage; its lanes split a D-wide row in 16-byte
// pieces (LPR lanes a row, a power of two, NV pieces a lane, RPI = 32 / LPR
// rows a warp instruction; a lane's pieces at or past d load nothing and add
// zero), and each group of LPR lanes keeps its own online-softmax state over
// the rows it sees, in registers: acc[g][its d piece] in every lane, each head's running
// max and sum in the lanes of that head's scores. The partial dot products of
// a sub-tile (up to 4 rows x g heads) reduce by halving exchanges of shuffles
// so that each lane ends with one whole score, whose exponential it alone
// takes; p and the rescale factors go back to every lane for P.V. The only
// block-wide waits in the walk are the ring's mbarriers. At the end the lane
// groups merge by shuffles, the warps in warp order through shared memory,
// and after a cluster barrier the S blocks' partials in rank order through
// distributed shared memory, each block merging and writing its share of
// the output elements: no atomics and no scratch in device memory, and the
// same output every run. All arithmetic is f32 (scores in log2 units, for
// exp2); the output is rounded to T once.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "hopper.cuh"

namespace decode_split {

constexpr int STAGE_ROWS = 64;                   // rows a stage holds at most
constexpr int MAX_SPLITS = 8;                    // blocks of a cluster
constexpr int SMEM_MAX = 232448;                 // shared memory a block may ask for

// the most stages, from `most` down to 1, that fit SMEM_MAX beside `fixed` bytes
constexpr int fit_stages(int most, int per_stage, int fixed) {
    return most > 1 && fixed + most * per_stage > SMEM_MAX
               ? fit_stages(most - 1, per_stage, fixed)
               : most;
}

// A block of G query heads: NCW consumer warps and one producer warp. At
// G = 4 a row costs four heads' products, and one warp a scheduler cannot
// hide its chain of loads, shuffles and exponentials: 8 consumer warps of 8
// rows a stage. At G <= 2, 4 warps of 16 rows: at 288 threads three blocks
// an SM would not fit in the register file.
template <typename T, int D, int G>
struct Shape {
    static constexpr int NCW = G >= 4 ? 8 : 4;            // consumer warps
    static constexpr int WARP_ROWS = STAGE_ROWS / NCW;    // a consumer warp's rows a stage
    static constexpr int NTHREADS = (NCW + 1) * 32;
    static constexpr int VEC = 16 / (int)sizeof(T);       // elements a piece (a lane's load)
    static constexpr int RV = D / VEC;                    // pieces of a D-wide row
    static constexpr int LPR = RV < 32 ? RV : 32;         // lanes a row
    static constexpr int NV = RV / LPR;                   // pieces a lane: 2 in f32 at D 256
    static constexpr int RPI = 32 / LPR;                  // rows a warp instruction
    static constexpr int NI = WARP_ROWS / RPI;            // a lane group's rows a stage
    static constexpr int TS = NI < 4 ? NI : 4;            // of them a softmax update
    static constexpr int NSUB = NI / TS;
    static constexpr int STAGE_BYTES = 2 * STAGE_ROWS * D * (int)sizeof(T);   // K and V
    // ring stages: 4 of at most 16 KB, else 3, fewer where they would not fit
    // beside the partials (the key window and barriers counted a stage)
    static constexpr int NST =
        fit_stages(STAGE_BYTES <= 16384 ? 4 : 3, STAGE_BYTES + 4 * STAGE_ROWS + 16,
                   (int)sizeof(float) * (NCW + 1) * G * (D + 2));
    static_assert(RV % LPR == 0 && NI % TS == 0, "a row must split over a warp");
};

// shared memory of split_block: the ring [NST][K, V][64][D] of T (rows d
// apart), the warps' partials [NCW][G][D + 2] and the block's [G][D + 2]
// floats (acc, then m and l), the producer's window of unit keys [NST * 64]
// (KEYED units only) and the full and empty mbarriers [2][NST]
template <typename T, int D, int G, bool KEYED = true>
__host__ __device__ constexpr size_t smem_bytes() {
    using Sh = Shape<T, D, G>;
    return (size_t)Sh::NST * Sh::STAGE_BYTES + sizeof(float) * (Sh::NCW + 1) * G * (D + 2) +
           (KEYED ? sizeof(int) * Sh::NST * STAGE_ROWS : 0) + 16 * Sh::NST;
}

// 2^(m - m_new) (scores are kept in log2 units), 0 for a state that has
// seen no row (m = -inf), also where m_new is -inf too
__device__ __forceinline__ float rescale(float m, float m_new) {
    return m == -INFINITY ? 0.f : exp2f(m - m_new);
}

// the VEC values of T packed in raw, in f32
template <typename T, int VEC>
__device__ __forceinline__ void widen(const uint4& raw, float (&f)[VEC]) {
    if constexpr (std::is_same<T, float>::value) {
        f[0] = __uint_as_float(raw.x);
        f[1] = __uint_as_float(raw.y);
        f[2] = __uint_as_float(raw.z);
        f[3] = __uint_as_float(raw.w);
    } else {
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 p = hopper::unpack2<T>(w[i]);
            f[2 * i] = p.x;
            f[2 * i + 1] = p.y;
        }
    }
}

// The halving exchanges of a lane group's N partial sums sc[0, N) (N a power
// of two): at each level the lane whose bit SPREAD * N / 2 is set keeps the
// upper half of the sums left and its partner the lower, and each adds the
// other's half, until one is left. Lane li then holds score li / SPREAD,
// summed over the lanes that differ from it in bits SPREAD .. SPREAD * N / 2;
// the SPREAD lanes that share it finish the sum by plain exchanges.
template <int N, int SPREAD, int V>
__device__ __forceinline__ void halving_exchange(float (&sc)[V], int li) {
    if constexpr (N > 1) {
        constexpr int off = SPREAD * N / 2;
        const bool up = (li & off) != 0;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
            const float send = up ? sc[i] : sc[i + N / 2];
            const float keep = up ? sc[i + N / 2] : sc[i];
            sc[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
        halving_exchange<N / 2, SPREAD, V>(sc, li);
    }
}

// the key of unit u of KEYED units; nothing is read for others
template <typename Units>
__device__ __forceinline__ int unit_key(const Units& units, int u) {
    if constexpr (Units::KEYED)
        return units.key(u);
    else
        return 0;
}

// One block of a cluster of S: the g_used (<= G) query heads at q (g_used x d,
// written to out likewise; d <= D) against the first len rows of the
// sequence that units describes in k and v. smem: smem_bytes<T, D, G,
// Units::KEYED>().
template <typename T, int D, int G, typename Units>
__device__ __forceinline__ void split_block(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v, T* __restrict__ out,
                                            int len, int g_used, int d, float scale,
                                            const Units& units, unsigned char* smem) {
    using Sh = Shape<T, D, G>;
    constexpr int VEC = Sh::VEC, LPR = Sh::LPR, NV = Sh::NV, RPI = Sh::RPI, TS = Sh::TS;
    constexpr int NSUB = Sh::NSUB, NST = Sh::NST, NCW = Sh::NCW, NTHREADS = Sh::NTHREADS;
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int splits = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();

    T* ring = reinterpret_cast<T*>(smem);
    float* part = reinterpret_cast<float*>(smem + (size_t)NST * Sh::STAGE_BYTES);
    float* blk = part + NCW * G * (D + 2);
    int* win = reinterpret_cast<int*>(blk + G * (D + 2));
    uint64_t* bars =                                                         // full, empty
        reinterpret_cast<uint64_t*>(win + (Units::KEYED ? NST * STAGE_ROWS : 0));

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int share = (units.count + splits - 1) / splits;
    const int u_begin = min(rank * share, units.count);
    const int u_end = min(u_begin + share, units.count);
    const int pps = units.per_stage;
    const int n_st = (u_end - u_begin + pps - 1) / pps;
    // a stage's units and rows: every unit but the last is full
    auto stage_units = [&](int s) { return min(pps, u_end - u_begin - s * pps); };
    auto stage_rows = [&](int s) {
        const int un = stage_units(s);
        return (un - 1) * units.unit_rows + units.rows(u_begin + s * pps + un - 1);
    };

    // the producer loads the keys of a window of NST stages a window ahead,
    // all at once, and keeps them in win while their stages are issued (units
    // without keys: none); the consumers hold q (scaled) in registers. Both
    // loads go out before the barriers are set up.
    constexpr int KPL = NST * STAGE_ROWS / 32;     // keys a lane loads a window
    int keys[KPL];
    auto load_keys = [&](int s0) {
        const int u0 = u_begin + s0 * pps;
        const int nu = min(NST * pps, u_end - u0);
#pragma unroll
        for (int i = 0; i < KPL; ++i)
            keys[i] = lane + 32 * i < nu ? unit_key(units, u0 + lane + 32 * i) : 0;
    };
    const int lg = lane / LPR, li = lane % LPR;
    // this lane's pieces: columns col(n) .. col(n) + VEC - 1 of a row, live
    // where they lie before d (d is a multiple of VEC)
    auto col = [&](int n) { return (li + n * LPR) * VEC; };
    bool live[NV];
#pragma unroll
    for (int n = 0; n < NV; ++n) live[n] = col(n) < d;
    float qf[G][NV][VEC];
    if (warp == NCW) {
        if constexpr (Units::KEYED) load_keys(0);
    } else {
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
            for (int n = 0; n < NV; ++n) {
                if (j < g_used && live[n]) {
                    widen<T, VEC>(load16(q + j * d + col(n)), qf[j][n]);
                } else {
#pragma unroll
                    for (int e = 0; e < VEC; ++e) qf[j][n][e] = 0.f;
                }
            }
    }
    if (tid == 0) {
        for (int s = 0; s < NST; ++s) {
            hopper::mbar_init(hopper::smem_addr(&bars[s]), 1);
            hopper::mbar_init(hopper::smem_addr(&bars[NST + s]), NCW);
        }
        hopper::mbar_fence_init();
    }
    __syncthreads();

    if (warp == NCW) {
        // the producer: a stage's bytes onto its full barrier, then one bulk
        // copy a unit for K and one for V, spread over the warp's lanes
        for (int s = 0; s < n_st; ++s) {
            const int slot = s % NST;
            const int u0 = u_begin + s * pps;
            if constexpr (Units::KEYED) {
                if (slot == 0) {
#pragma unroll
                    for (int i = 0; i < KPL; ++i) win[lane + 32 * i] = keys[i];
                    __syncwarp();
                    if (s + NST < n_st) load_keys(s + NST);
                }
            }
            if (s >= NST)       // the consumers are done with this slot's last stage
                hopper::mbar_wait(hopper::smem_addr(&bars[NST + slot]), (s / NST - 1) & 1);
            const uint32_t full = hopper::smem_addr(&bars[slot]);
            if (lane == 0)
                hopper::mbar_arrive_expect_tx(full, 2u * stage_rows(s) * d * sizeof(T));
            __syncwarp();
            T* ks = ring + (size_t)slot * 2 * STAGE_ROWS * D;
            T* vs = ks + STAGE_ROWS * D;
            for (int i = lane; i < stage_units(s); i += 32) {
                const int u = u0 + i;
                size_t off;
                if constexpr (Units::KEYED)
                    off = units.offset(u, win[slot * pps + i]);
                else
                    off = units.offset(u);
                const uint32_t bytes = units.rows(u) * d * sizeof(T);
                hopper::bulk_load(hopper::smem_addr(ks + i * units.unit_rows * d), k + off, bytes,
                                  full);
                hopper::bulk_load(hopper::smem_addr(vs + i * units.unit_rows * d), v + off, bytes,
                                  full);
            }
        }
    } else {
        // A sub-tile is TS rows of each lane group, V = TS * G scores, score
        // v = j * TS + t (head j, row t). The group's LPR lanes reduce them
        // by halving exchanges: each lane ends with score vi = li / SPREAD,
        // summed over the group (SPREAD lanes hold each), and runs the
        // online softmax of that one score; the head's running max and sum
        // (mh, lh) live in the lanes of its scores. p of every score and the
        // rescale factor of every head then go back to all lanes for P.V.
        constexpr int V = TS * G, SPREAD = LPR / V;
        static_assert(V <= LPR, "a lane group holds at least one lane a score");
        const int vi = li / SPREAD, ht = vi % TS;
        const int gbase = lg * LPR;
        float acc[G][NV][VEC];
        float mh = -INFINITY, lh = 0.f;
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
            for (int n = 0; n < NV; ++n)
#pragma unroll
                for (int e = 0; e < VEC; ++e) {
                    qf[j][n][e] *= scale * hopper::LOG2E;    // scores in log2 units: exp2
                    acc[j][n][e] = 0.f;
                }

        for (int s = 0; s < n_st; ++s) {
            const int slot = s % NST;
            hopper::mbar_wait(hopper::smem_addr(&bars[slot]), (s / NST) & 1);
            const int first = units.first_row(u_begin + s * pps);
            const int nvalid = min(stage_rows(s), len - first);
            const T* ks = ring + (size_t)slot * 2 * STAGE_ROWS * D;
            const T* vs = ks + STAGE_ROWS * D;
#pragma unroll
            for (int sub = 0; sub < NSUB; ++sub) {
                const int r0 = warp * Sh::WARP_ROWS + sub * TS * RPI;
                if (r0 >= nvalid) break;
                float sc[V];
#pragma unroll
                for (int t = 0; t < TS; ++t) {
#pragma unroll
                    for (int j = 0; j < G; ++j) sc[j * TS + t] = 0.f;
#pragma unroll
                    for (int n = 0; n < NV; ++n) {
                        if (!live[n]) continue;
                        float kf[VEC];
                        widen<T, VEC>(load16(ks + (r0 + t * RPI + lg) * d + col(n)), kf);
#pragma unroll
                        for (int j = 0; j < G; ++j) {
                            float dot = sc[j * TS + t];
#pragma unroll
                            for (int e = 0; e < VEC; ++e) dot = fmaf(qf[j][n][e], kf[e], dot);
                            sc[j * TS + t] = dot;
                        }
                    }
                }
                halving_exchange<V, SPREAD>(sc, li);
#pragma unroll
                for (int off = SPREAD / 2; off > 0; off >>= 1)
                    sc[0] += __shfl_xor_sync(0xffffffffu, sc[0], off);
                const float x = r0 + ht * RPI + lg < nvalid ? sc[0] : -INFINITY;
                // the head's max and sum over its TS rows: lanes SPREAD apart
                float mx = x;
#pragma unroll
                for (int off = SPREAD; off < SPREAD * TS; off <<= 1)
                    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
                mx = fmaxf(mh, mx);
                const float alpha = rescale(mh, mx);
                const float p = rescale(x, mx);
                float ps = p;
#pragma unroll
                for (int off = SPREAD; off < SPREAD * TS; off <<= 1)
                    ps += __shfl_xor_sync(0xffffffffu, ps, off);
                lh = lh * alpha + ps;
                mh = mx;
#pragma unroll
                for (int j = 0; j < G; ++j) {
                    const float a = __shfl_sync(0xffffffffu, alpha, gbase + j * TS * SPREAD);
#pragma unroll
                    for (int n = 0; n < NV; ++n)
#pragma unroll
                        for (int e = 0; e < VEC; ++e) acc[j][n][e] *= a;
                }
                float pv[V];
#pragma unroll
                for (int i = 0; i < V; ++i) pv[i] = __shfl_sync(0xffffffffu, p, gbase + i * SPREAD);
#pragma unroll
                for (int t = 0; t < TS; ++t) {
                    if (r0 + t * RPI + lg < nvalid) {
#pragma unroll
                        for (int n = 0; n < NV; ++n) {
                            if (!live[n]) continue;
                            float vf[VEC];
                            widen<T, VEC>(load16(vs + (r0 + t * RPI + lg) * d + col(n)), vf);
#pragma unroll
                            for (int j = 0; j < G; ++j)
#pragma unroll
                                for (int e = 0; e < VEC; ++e)
                                    acc[j][n][e] = fmaf(pv[j * TS + t], vf[e], acc[j][n][e]);
                        }
                    }
                }
            }
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(hopper::smem_addr(&bars[NST + slot]));
        }

        // the warp's lane groups merge (lanes li of every group end up equal)
        float m[G], l[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
            m[j] = __shfl_sync(0xffffffffu, mh, gbase + j * TS * SPREAD);
            l[j] = __shfl_sync(0xffffffffu, lh, gbase + j * TS * SPREAD);
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
            float mx = m[j];
#pragma unroll
            for (int off = LPR; off < 32; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float sc = rescale(m[j], mx);
            l[j] *= sc;
#pragma unroll
            for (int n = 0; n < NV; ++n)
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[j][n][e] *= sc;
#pragma unroll
            for (int off = LPR; off < 32; off <<= 1) {
                l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
#pragma unroll
                for (int n = 0; n < NV; ++n)
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
                        acc[j][n][e] += __shfl_xor_sync(0xffffffffu, acc[j][n][e], off);
            }
            m[j] = mx;
        }
        if (lg == 0) {
#pragma unroll
            for (int j = 0; j < G; ++j) {
                float* pw = part + (warp * G + j) * (D + 2);
#pragma unroll
                for (int n = 0; n < NV; ++n)
                    if (live[n]) {
#pragma unroll
                        for (int e = 0; e < VEC; ++e) pw[col(n) + e] = acc[j][n][e];
                    }
                if (li == 0) {
                    pw[D] = m[j];
                    pw[D + 1] = l[j];
                }
            }
        }
    }
    __syncthreads();

    // the block's partial: its warps merged in warp order
    for (int e = tid; e < G * d; e += NTHREADS) {
        const int j = e / d, c = e % d;
        float mx = -INFINITY;
        for (int w = 0; w < NCW; ++w) mx = fmaxf(mx, part[(w * G + j) * (D + 2) + D]);
        float a = 0.f, ls = 0.f;
        for (int w = 0; w < NCW; ++w) {
            const float* pw = part + (w * G + j) * (D + 2);
            const float sc = rescale(pw[D], mx);
            a = fmaf(pw[c], sc, a);
            ls = fmaf(pw[D + 1], sc, ls);
        }
        blk[j * (D + 2) + c] = a;
        if (c == 0) {
            blk[j * (D + 2) + D] = mx;
            blk[j * (D + 2) + D + 1] = ls;
        }
    }
    cluster.sync();

    // the output's elements are dealt over the cluster's blocks; each merges
    // the S partials of its elements in rank order, all S remote reads of an
    // element in flight at once
    for (int e = rank * NTHREADS + tid; e < g_used * d; e += splits * NTHREADS) {
        const int j = e / d, c = e % d;
        float bm[MAX_SPLITS], bl[MAX_SPLITS], ba[MAX_SPLITS];
#pragma unroll
        for (int r = 0; r < MAX_SPLITS; ++r) {
            bm[r] = -INFINITY;
            bl[r] = ba[r] = 0.f;
            if (r < splits) {
                const float* br = cluster.map_shared_rank(blk, r) + j * (D + 2);
                bm[r] = br[D];
                bl[r] = br[D + 1];
                ba[r] = br[c];
            }
        }
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < MAX_SPLITS; ++r) mx = fmaxf(mx, bm[r]);
        float a = 0.f, ls = 0.f;
#pragma unroll
        for (int r = 0; r < MAX_SPLITS; ++r) {
            const float sc = rescale(bm[r], mx);
            a = fmaf(ba[r], sc, a);
            ls = fmaf(bl[r], sc, ls);
        }
        out[e] = from_f32<T>(ls > 0.f ? a / ls : 0.f);
    }
    cluster.sync();   // no block leaves while another reads its shared memory
}

}  // namespace decode_split
