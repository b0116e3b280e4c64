// Decode attention against a head-major KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/decode.py:_decode_kernel
// (launched by the pallas_call in decode_attention): one decode step of
// q (b, h, d) against k/v caches (b, h_kv, T, d), each sequence masked by its
// cache_len, the g = h / h_kv query heads of a kv group sharing one pass over
// that group's cache rows. f32 scores and online softmax; the output is in
// q's dtype; a sequence with cache_len 0 returns zeros (the TPU kernel's
// l_safe).
//
// What bounds it on this card: every cache byte read feeds 2 g multiply-adds,
// far below the H100's ~295 operations a byte, so device-memory bytes bound
// it, and the bytes it must move are the valid K/V rows, sum(cache_len) *
// h_kv * d * 2 elements: only the first cdiv(cache_len, 64) tiles of a
// (sequence, kv head) are read, never the whole capacity T, and each once
// for all the heads a block takes.
//
// Design: the body is decode_split.cuh, as for the paged kernel (see there).
// Its units are 64-row tiles of one (sequence, kv head)'s contiguous rows:
// a stage is one tile, arriving as ONE bulk copy for K and one for V, cut at
// cache_len (so never past T), and locating a tile reads nothing from device
// memory (no table, no key window). Each (sequence, kv head) is split over
// the S blocks of a thread-block cluster, S in {1, 2, 4, 8} chosen on the
// host from shapes alone (decode_split in ops/attention/decode.py: no read
// of cache_len, no host sync); on the device each block takes a contiguous
// share of the sequence's cdiv(cache_len, 64) tiles, so a pair's blocks
// carry equal work whatever its length, and the S partials merge once, in
// rank order, through distributed shared memory.
//
// Grid: (b * h_kv * S, cdiv(g, G)) blocks, clusters of (S, 1, 1), launched
// with cudaLaunchKernelEx; G, the query heads a block takes, is the least of
// 1, 2, 4 that covers g (more than 4 heads a group take several head blocks,
// each reading the group's rows). One launch a call.

#include <limits.h>

#include "decode_split.cuh"

namespace {

using decode_split::STAGE_ROWS;

// the rows of one (sequence, kv head) as the body's units: its 64-row tiles,
// the last cut at len
struct DenseUnits {
    static constexpr bool KEYED = false;
    static constexpr int per_stage = 1;
    static constexpr int unit_rows = STAGE_ROWS;
    size_t base;        // element offset of the pair's row 0 in k and v
    int len;            // valid rows, at most the capacity
    int count;          // tiles that hold them
    int d;              // head_dim: the rows' stride
    __device__ __forceinline__ size_t offset(int u) const {
        return base + (size_t)u * STAGE_ROWS * d;
    }
    __device__ __forceinline__ int first_row(int u) const { return u * STAGE_ROWS; }
    __device__ __forceinline__ int rows(int u) const {
        return min(STAGE_ROWS, len - u * STAGE_ROWS);
    }
};

template <typename T, int D, int G, bool EXACT>
__global__ void __launch_bounds__(decode_split::Shape<T, D, G>::NTHREADS, 1)
dense_decode_split(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                   const int* __restrict__ lens, T* __restrict__ out, int hk, int g, int cap,
                   int d, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    // the exact build (d == D) folds the strides and guards below to constants
    if constexpr (EXACT) d = D;

    const int splits = (int)cooperative_groups::this_cluster().num_blocks();
    const int pair = blockIdx.x / splits;
    const int bi = pair / hk, kh = pair % hk;
    const int j0 = blockIdx.y * G;
    const int len = min(max(lens[bi], 0), cap);
    const DenseUnits units{((size_t)bi * hk + kh) * (size_t)cap * d, len,
                           (len + STAGE_ROWS - 1) / STAGE_ROWS, d};
    const size_t qoff = (((size_t)bi * hk + kh) * g + j0) * d;
    decode_split::split_block<T, D, G>(q + qoff, kc, vc, out + qoff, len, min(G, g - j0), d,
                                       scale, units, smem);
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* lens, void* out,
                   int b, int hk, int g, int cap, int d, float scale, int splits,
                   cudaStream_t stream) {
    constexpr size_t smem = decode_split::smem_bytes<T, D, G, false>();
    auto* kernel = d == D ? dense_decode_split<T, D, G, true> : dense_decode_split<T, D, G, false>;
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
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(kc),
                             static_cast<const T*>(vc), static_cast<const int*>(lens),
                             static_cast<T*>(out), hk, g, cap, d, scale);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const void* q, const void* kc, const void* vc, const void* lens, void* out,
                       int b, int hk, int g, int cap, int d, float scale, int splits,
                       cudaStream_t stream) {
    if (g <= 1)
        return launch<T, D, 1>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, splits, stream);
    if (g <= 2)
        return launch<T, D, 2>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, splits, stream);
    return launch<T, D, 4>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, splits, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* kc, const void* vc, const void* lens, void* out,
                       int b, int hk, int g, int cap, int d, float scale, int splits,
                       cudaStream_t stream) {
    switch (build_width(d, 256)) {
        case 64:
            return dispatch_g<T, 64>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, splits,
                                     stream);
        case 128:
            return dispatch_g<T, 128>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, splits,
                                      stream);
        case 256:
            return dispatch_g<T, 256>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, splits,
                                      stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// q, out: (b, hk*g, d); k_cache, v_cache: (b, hk, cap, d), all contiguous in
// `dtype`, 16-byte aligned, d a multiple of 8 up to 256; lens: (b,) int32 valid rows per sequence;
// splits: the blocks of a cluster that share one (sequence, kv head), 1, 2,
// 4 or 8. Returns cudaGetLastError(), or the error of a launch the card
// refuses.
extern "C" int decode_attention(const void* q, const void* kc, const void* vc, const void* lens,
                                void* out, int b, int hk, int g, int cap, int d, float scale,
                                int splits, int dtype, void* stream) {
    if (b <= 0 || hk <= 0 || g <= 0 || cap <= 0 || hk > 65535 ||
        (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
        (long long)b * hk * splits > INT_MAX || (g + 3) / 4 > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case DS_F32:
            return (int)dispatch_d<float>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, splits,
                                          s);
        case DS_F16:
            return (int)dispatch_d<__half>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, splits,
                                           s);
        case DS_BF16:
            return (int)dispatch_d<__nv_bfloat16>(q, kc, vc, lens, out, b, hk, g, cap, d, scale,
                                                  splits, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
