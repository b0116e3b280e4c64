// Paged decode attention: one decode step against a global pool of KV pages,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/paged_attention.py:_paged_decode_kernel
// (launched by the pallas_call in paged_attention_fused): q (b, h, d) against
// k/v pages (P, h_kv, page, d); row r of slot i lives in physical page
// table[i, r / page] at offset r % page, and slot i attends over its rows
// [0, cache_len[i]). The g = h / h_kv query heads of a kv group share one pass
// over that group's rows. f32 scores and online softmax; the output is in q's
// dtype; a slot with cache_len 0 returns zeros. Page 0 is the pool's null
// page: table entries past a slot's live pages point at it, and this kernel
// never reads them.
//
// What bounds it on this card: as the dense decode kernel, every K/V byte
// read feeds 2*g multiply-adds, far below the H100's ~295 operations a byte,
// so device-memory bytes bound it, and the bytes it must move are the valid
// K/V rows, sum(cache_len) * h_kv * d * 2 elements. The design reads nothing
// else: a block reads only its slot's cdiv(cache_len, page) live table
// entries, through the read-only cache (a warp's 16-byte loads span at most
// four rows, so at most four entries, each a broadcast), and loads only rows
// of those pages, 16 bytes a thread, through the tile loop of decode_core.cuh
// (tiles of 64 rows that may span several pages). Shared memory holds only
// the tile loop's buffers, whatever the table's width, so any page size >= 1
// and any cap work, since a row of d values is a whole number of 16-byte
// vectors. Physical pages may be in any order.
//
// Layout: one block of 128 threads per (slot, kv head). At 16 slots and 12 kv
// heads (GPT-2 serving) that is 192 blocks on 132 SMs; splitting long
// sequences across blocks, TMA page loads and a CUDA graph of the serving
// chunk are later work.

#include "decode_core.cuh"

namespace {

using decode_core::NTHREADS;

// the rows of one (slot, kv head): row r in page tbl[r / page] at offset
// r % page; rows of the live pages (r < live_rows) have storage
template <int D>
struct PagedRows {
    const int* tbl;     // the slot's table row, in device memory
    int page;
    int hk;
    int kh;
    int live_rows;      // cdiv(len, page) * page
    __device__ __forceinline__ bool readable(int r) const { return r < live_rows; }
    __device__ __forceinline__ size_t offset(int r) const {
        const size_t p = (size_t)__ldg(tbl + r / page);
        return ((p * hk + kh) * page + (size_t)(r % page)) * D;
    }
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ table, const int* __restrict__ lens,
                    T* __restrict__ out, int hk, int g, int page, int max_pages, float scale) {
    extern __shared__ float smem[];
    const int bi = blockIdx.x;
    const int kh = blockIdx.y;
    const int len = min(max(lens[bi], 0), max_pages * page);
    const int npg = (len + page - 1) / page;            // only the live pages are read
    const size_t qoff = ((size_t)bi * hk + kh) * g * D;
    const PagedRows<D> rows{table + (size_t)bi * max_pages, page, hk, kh, npg * page};
    decode_core::decode_block<T, D>(q + qoff, kp, vp, out + qoff, len, g, scale, rows, smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* table,
                   const void* lens, void* out, int b, int hk, int g, int page, int max_pages,
                   float scale, cudaStream_t stream) {
    const size_t smem = sizeof(float) * decode_core::smem_floats<D>(g);
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(b, hk);
    paged_decode_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
        static_cast<const int*>(table), static_cast<const int*>(lens), static_cast<T*>(out),
        hk, g, page, max_pages, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp, const void* table,
                       const void* lens, void* out, int b, int hk, int g, int page,
                       int max_pages, int d, float scale, cudaStream_t stream) {
    if (d == 64)
        return launch<T, 64>(q, kp, vp, table, lens, out, b, hk, g, page, max_pages, scale,
                             stream);
    if (d == 128)
        return launch<T, 128>(q, kp, vp, table, lens, out, b, hk, g, page, max_pages, scale,
                              stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (b, hk*g, d); k_pages, v_pages: (P, hk, page, d), all contiguous in
// `dtype`; table: (b, max_pages) int32 physical page indices; lens: (b,)
// int32 valid rows per slot. Returns cudaGetLastError().
extern "C" int paged_decode_attention(const void* q, const void* kp, const void* vp,
                                      const void* table, const void* lens, void* out, int b,
                                      int hk, int g, int page, int max_pages, int d, float scale,
                                      int dtype, void* stream) {
    if (b <= 0 || hk <= 0 || g <= 0 || page <= 0 || max_pages <= 0 || hk > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DS_F32:
            return (int)dispatch_d<float>(q, kp, vp, table, lens, out, b, hk, g, page, max_pages,
                                          d, scale, s);
        case DS_F16:
            return (int)dispatch_d<__half>(q, kp, vp, table, lens, out, b, hk, g, page,
                                           max_pages, d, scale, s);
        case DS_BF16:
            return (int)dispatch_d<__nv_bfloat16>(q, kp, vp, table, lens, out, b, hk, g, page,
                                                  max_pages, d, scale, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
