// Paged decode attention: one decode step against a global pool of KV pages,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/paged_attention.py:_paged_decode_kernel
// (launched by the pallas_call in paged_attention_fused): q (b, h, d) against
// k/v pages (P, h_kv, page, d); row r of slot i lives in physical page
// table[i, r / page] at offset r % page, and slot i attends over its rows
// [0, cache_len[i]). The g = h / h_kv query heads of a kv group share one pass
// over that group's rows. f32 scores and online softmax, rows at or past
// cache_len masked; the output is in q's dtype; a slot with cache_len 0
// returns zeros. Page 0 is the pool's null page: table entries past a slot's
// live pages point at it, and this kernel never reads them.
//
// What bounds it on this card: every K/V byte read feeds 2 g multiply-adds,
// far below the H100's ~295 operations a byte, so device-memory bytes bound
// it, and the bytes it must move are the valid K/V rows, sum(cache_len) *
// h_kv * d * 2 elements, and the live table entries.
//
// Design (the body is decode_split.cuh; see there): each (slot, kv head) is
// split over the S blocks of a thread-block cluster, S in {1, 2, 4, 8} chosen
// on the host from shapes alone (paged_split in ops/paged_attention.py: no
// read of cache_len, no host sync); on the device each block takes a
// contiguous share of the slot's live pages, computed from cache_len, so a
// pair's blocks carry equal work whatever its length. A page of one kv head
// is page * d contiguous elements, so it arrives as ONE bulk copy (K and V
// each) onto its stage's mbarrier: a stage is cdiv(64, page) pages, 64 rows
// or fewer (a page longer than 64 rows arrives in 64-row pieces), in a ring
// of 3-4 stages kept full by the producer warp, which reads the live table
// entries once. The units of the body are pages, and only a slot's
// cdiv(cache_len, page) live pages are read. Shared memory depends on the
// dtype, d and the heads a block takes only, never on the table's width, so
// any page size >= 1 and any cap work. Physical pages may be in any order.
//
// Grid: (b * h_kv * S, cdiv(g, G)) blocks, clusters of (S, 1, 1), launched
// with cudaLaunchKernelEx; G, the query heads a block takes, is the least of
// 1, 2, 4 that covers g (more than 4 heads a group take several head blocks,
// each reading the group's pages: four heads' q and accumulators are what
// the registers of a block's consumer warps hold). One launch a call.

#include <limits.h>

#include "decode_split.cuh"

namespace {

using decode_split::STAGE_ROWS;

// the pages of one (slot, kv head) as the body's units: a page, or at a page
// longer than 64 rows its 64-row pieces (spp of them)
template <int D>
struct PagedUnits {
    static constexpr bool KEYED = true;
    const int* tbl;     // the slot's table row, in device memory
    int page;
    int hk;
    int kh;
    int count;          // live units
    int per_stage;      // units a stage: 64 / page pages, or one piece
    int unit_rows;      // min(page, 64)
    int spp;            // units a page: cdiv(page, 64)
    __device__ __forceinline__ int key(int u) const { return __ldg(tbl + u / spp); }
    __device__ __forceinline__ size_t offset(int u, int key) const {
        return (((size_t)key * hk + kh) * page + (size_t)(u % spp) * STAGE_ROWS) * D;
    }
    __device__ __forceinline__ int first_row(int u) const {
        return (u / spp) * page + (u % spp) * STAGE_ROWS;
    }
    __device__ __forceinline__ int rows(int u) const {
        return min(STAGE_ROWS, page - (u % spp) * STAGE_ROWS);
    }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(decode_split::Shape<T, D, G>::NTHREADS, 1)
paged_decode_split(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                   const int* __restrict__ table, const int* __restrict__ lens,
                   T* __restrict__ out, int hk, int g, int page, int max_pages, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int splits = (int)cooperative_groups::this_cluster().num_blocks();
    const int pair = blockIdx.x / splits;
    const int bi = pair / hk, kh = pair % hk;
    const int j0 = blockIdx.y * G;
    const int len = min(max(lens[bi], 0), max_pages * page);
    const int npg = (len + page - 1) / page;            // only the live pages are read
    const int spp = (page + STAGE_ROWS - 1) / STAGE_ROWS;
    // the live units of the last live page: 1, or its pieces up to row len - 1
    const int last = npg > 0 ? (len - (npg - 1) * page + STAGE_ROWS - 1) / STAGE_ROWS : 0;
    const PagedUnits<D> units{table + (size_t)bi * max_pages, page, hk, kh,
                              max(npg - 1, 0) * spp + last,
                              page <= STAGE_ROWS ? STAGE_ROWS / page : 1, min(page, STAGE_ROWS),
                              spp};
    const size_t qoff = (((size_t)bi * hk + kh) * g + j0) * D;
    decode_split::split_block<T, D, G>(q + qoff, kp, vp, out + qoff, len, min(G, g - j0), scale,
                                       units, smem);
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* table,
                   const void* lens, void* out, int b, int hk, int g, int page, int max_pages,
                   float scale, int splits, cudaStream_t stream) {
    constexpr size_t smem = decode_split::smem_bytes<T, D, G>();
    auto* kernel = paged_decode_split<T, D, G>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(b * hk * splits), (unsigned)((g + G - 1) / G), 1);
    cfg.blockDim = dim3(decode_split::Shape<T, D, G>::NTHREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                             static_cast<const T*>(kp), static_cast<const T*>(vp),
                             static_cast<const int*>(table), static_cast<const int*>(lens),
                             static_cast<T*>(out), hk, g, page, max_pages, scale);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const void* q, const void* kp, const void* vp, const void* table,
                       const void* lens, void* out, int b, int hk, int g, int page,
                       int max_pages, float scale, int splits, cudaStream_t stream) {
    if (g <= 1)
        return launch<T, D, 1>(q, kp, vp, table, lens, out, b, hk, g, page, max_pages, scale,
                               splits, stream);
    if (g <= 2)
        return launch<T, D, 2>(q, kp, vp, table, lens, out, b, hk, g, page, max_pages, scale,
                               splits, stream);
    return launch<T, D, 4>(q, kp, vp, table, lens, out, b, hk, g, page, max_pages, scale, splits,
                           stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp, const void* table,
                       const void* lens, void* out, int b, int hk, int g, int page,
                       int max_pages, int d, float scale, int splits, cudaStream_t stream) {
    if (d == 64)
        return dispatch_g<T, 64>(q, kp, vp, table, lens, out, b, hk, g, page, max_pages, scale,
                                 splits, stream);
    if (d == 128)
        return dispatch_g<T, 128>(q, kp, vp, table, lens, out, b, hk, g, page, max_pages, scale,
                                  splits, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (b, hk*g, d); k_pages, v_pages: (P, hk, page, d), all contiguous in
// `dtype`, 16-byte aligned; table: (b, max_pages) int32 physical page
// indices; lens: (b,) int32 valid rows per slot; splits: the blocks of a
// cluster that share one (slot, kv head), 1, 2, 4 or 8. Returns
// cudaGetLastError(), or the error of a launch the card refuses.
extern "C" int paged_decode_attention(const void* q, const void* kp, const void* vp,
                                      const void* table, const void* lens, void* out, int b,
                                      int hk, int g, int page, int max_pages, int d, float scale,
                                      int splits, int dtype, void* stream) {
    if (b <= 0 || hk <= 0 || g <= 0 || page <= 0 || max_pages <= 0 ||
        (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
        (long long)b * hk * splits > INT_MAX || (g + 3) / 4 > 65535 ||
        (long long)max_pages * page > INT_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DS_F32:
            return (int)dispatch_d<float>(q, kp, vp, table, lens, out, b, hk, g, page, max_pages,
                                          d, scale, splits, s);
        case DS_F16:
            return (int)dispatch_d<__half>(q, kp, vp, table, lens, out, b, hk, g, page,
                                           max_pages, d, scale, splits, s);
        case DS_BF16:
            return (int)dispatch_d<__nv_bfloat16>(q, kp, vp, table, lens, out, b, hk, g, page,
                                                  max_pages, d, scale, splits, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
