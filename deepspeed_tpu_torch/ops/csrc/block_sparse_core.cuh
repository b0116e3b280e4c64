// Shared by the block-sparse attention kernels on the CUDA cores (the f32
// paths of block_sparse_fwd.cu, block_sparse_bwd_dq.cu and
// block_sparse_bwd_dkv.cu): the geometry of a thread block, the staging of
// row tiles into shared memory, the check of the C entries' arguments and the
// dispatch over layout block and the build width of head_dim d (64 or 128;
// rows are d apart in device memory, and a tile's columns d .. D-1 are zero).
//
// One thread block owns one layout block of B rows (B = 16, 32, 64 or 128):
// a q-block in the forward and dq kernels, a k-block in the dk/dv kernel. It
// has 4*B threads; thread (ty, tx) = (tid / 16, tid % 16) owns rows
// 4*ty .. 4*ty+3 of those B rows, so the 16 threads of a row group sit in one
// half warp and row maxima and sums are shuffles. The other side of the score
// tile (the walked block's rows) is taken SUB = min(B, 32) rows at a time, of
// which the thread computes columns tx + 16*j; of a d-wide row it computes
// columns tx + 16*c. A walked block of 128 rows is four such sub-tiles: the
// online softmax is the same function over them, since wholly masked entries
// (past the diagonal) always lie to the right of a row's valid ones.
#pragma once

#include "common.cuh"

namespace block_sparse {

template <int B, int D>
struct Geom {
    static constexpr int NT = 4 * B;           // threads
    static constexpr int SUB = B < 32 ? B : 32; // rows of the walked block taken at once
    static constexpr int CJ = SUB / 16;        // score columns a thread
    static constexpr int DC = D / 16;          // d columns a thread
    static constexpr int DP = D + 1;           // padded row stride of a d-wide f32 tile
    static constexpr int SP = SUB + 1;         // padded row stride of a score tile
    static_assert(B % 16 == 0 && D % 16 == 0, "rows and head_dim split over 16 lanes");
};

// ROWS rows of a row-major (., d) matrix of T at src, widened to f32 into the
// first D columns of dst with row stride STRIDE (columns d .. D-1 zero), as
// 16-byte loads spread over the block's NT threads
template <typename T, int D, int ROWS, int STRIDE, int NT>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int d, int tid) {
    constexpr int VEC = vec_elems<T>();
    constexpr int ROW_VECS = D / VEC;
    for (int vi = tid; vi < ROWS * ROW_VECS; vi += NT) {
        const int r = vi / ROW_VECS, c = (vi % ROW_VECS) * VEC;
        store16_f32<T>(dst + r * STRIDE + c,
                       c < d ? load16(src + (size_t)r * d + c) : make_uint4(0u, 0u, 0u, 0u));
    }
}

// what every C entry refuses before it launches
inline bool bad_args(int bh, int t, int n_heads, int block, int max_n) {
    return bh <= 0 || bh > 65535 || t <= 0 || n_heads <= 0 || bh % n_heads != 0 ||
           block <= 0 || t % block != 0 || max_n <= 0;
}

// F::run<T, B, D>(args...) for the runtime layout block and the build width D
// of head_dim d (common.cuh: build_width), d itself among the args
template <typename F, typename T, int B, typename... A>
cudaError_t by_d(int d, A... args) {
    const int width = build_width(d, 128);
    if (width == 64) return F::template run<T, B, 64>(args...);
    if (width == 128) return F::template run<T, B, 128>(args...);
    return cudaErrorInvalidValue;
}

template <typename F, typename T, typename... A>
cudaError_t by_block(int block, int d, A... args) {
    switch (block) {
        case 16: return by_d<F, T, 16>(d, args...);
        case 32: return by_d<F, T, 32>(d, args...);
        case 64: return by_d<F, T, 64>(d, args...);
        case 128: return by_d<F, T, 128>(d, args...);
        default: return cudaErrorInvalidValue;
    }
}

// sets the kernel's dynamic shared memory and launches it on grid (nb, bh)
template <typename K, typename... A>
cudaError_t launch(K kernel, size_t smem, int nb, int bh, int threads, cudaStream_t stream,
                   A... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(nb, bh), threads, smem, stream>>>(args...);
    return cudaGetLastError();
}

}  // namespace block_sparse
