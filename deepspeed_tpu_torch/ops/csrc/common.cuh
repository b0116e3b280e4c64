// Shared by the port's kernels: dtype codes of the C interface, conversions
// between the storage types and float, and the error-string export every
// library carries so the Python wrapper can name a failed launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// dtype codes passed by the wrappers (deepspeed_tpu_torch/ops/op_builder.py users)
enum DsDtype { DS_F32 = 0, DS_F16 = 1, DS_BF16 = 2 };

constexpr float DS_NEG_INF = -1e30f;   // the masking value of the TPU kernels

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
    return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// The build width (64, 128 or 256) that runs head_dim d, or 0 where none does:
// d must be a multiple of 8 (a row of 16-bit values is then whole 16-byte
// pieces, as the TMA and bulk copies need) and at most max_width. A kernel
// built for width D takes the real d at run time: rows are d apart in device
// memory, columns d .. D-1 of its tiles are zeros, and its stores stop at d.
inline int build_width(int d, int max_width) {
    if (d <= 0 || d % 8 != 0 || d > max_width) return 0;
    return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// 16-byte vectors of T: the unit of the tile loads. A row of d elements (d a
// multiple of 8) is a whole number of them, and the wrappers require
// 16-byte-aligned tensors.
template <typename T> __host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(T); }

template <typename T> __device__ __forceinline__ uint4 load16(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
}

// widens the vec_elems<T>() values packed in `raw` to f32 at dst
template <typename T> __device__ __forceinline__ void store16_f32(float* dst, const uint4& raw) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < vec_elems<T>(); ++i) dst[i] = to_f32(e[i]);
}

// rounds x to T's precision and back, as a cast to the input dtype does
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max16(float x) {
    // max over the 16 lanes that share bit 4 of the lane index
    for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float warp_sum16(float x) {
    for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

__device__ __forceinline__ float warp_max32(float x) {
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float warp_sum32(float x) {
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

extern "C" const char* ds_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
