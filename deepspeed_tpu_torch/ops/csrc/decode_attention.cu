// Decode attention against a head-major KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/attention/decode.py:_decode_kernel
// (launched by the pallas_call in decode_attention): one decode step of
// q (b, h, d) against k/v caches (b, h_kv, T, d), each sequence masked by its
// cache_len, the g = h / h_kv query heads of a kv group sharing one pass over
// that group's cache rows. All arithmetic is f32; the output is in q's dtype.
//
// What bounds it on this card: every cache byte read feeds 2*g multiply-adds,
// a few operations a byte against the H100's ~295, so device-memory bytes
// bound it. The design reads only what the step needs: a block reads the
// first cdiv(cache_len, 64) tiles of its (sequence, kv head), never the whole
// capacity T, and reads them once for all g query heads of the group.
//
// Layout: one block of 128 threads per (sequence, kv head), running the tile
// loop of decode_core.cuh over that pair's contiguous cache rows. At batch 4
// and 12 kv heads that is 48 blocks on 132 SMs: splitting the sequence across
// blocks is later work.

#include "decode_core.cuh"

namespace {

using decode_core::NTHREADS;

// the rows of one (sequence, kv head): `cap` contiguous rows of D values
template <int D>
struct DenseRows {
    size_t base;
    int cap;
    __device__ __forceinline__ bool readable(int r) const { return r < cap; }
    __device__ __forceinline__ size_t offset(int r) const { return base + (size_t)r * D; }
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ lens, T* __restrict__ out, int hk, int g, int cap,
              float scale) {
    extern __shared__ float smem[];
    const int bi = blockIdx.x;
    const int kh = blockIdx.y;
    const int len = min(max(lens[bi], 0), cap);
    const size_t qoff = ((size_t)bi * hk + kh) * g * D;        // heads kh*g .. kh*g+g-1
    const DenseRows<D> rows{((size_t)bi * hk + kh) * (size_t)cap * D, cap};
    decode_core::decode_block<T, D>(q + qoff, kc, vc, out + qoff, len, g, scale, rows, smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* lens, void* out,
                   int b, int hk, int g, int cap, float scale, cudaStream_t stream) {
    const size_t smem = sizeof(float) * decode_core::smem_floats<D>(g);
    cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(b, hk);
    decode_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
        static_cast<const int*>(lens), static_cast<T*>(out), hk, g, cap, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* kc, const void* vc, const void* lens, void* out,
                       int b, int hk, int g, int cap, int d, float scale, cudaStream_t stream) {
    if (d == 64) return launch<T, 64>(q, kc, vc, lens, out, b, hk, g, cap, scale, stream);
    if (d == 128) return launch<T, 128>(q, kc, vc, lens, out, b, hk, g, cap, scale, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (b, hk*g, d); k_cache, v_cache: (b, hk, cap, d), all contiguous in
// `dtype`; lens: (b,) int32 valid rows per sequence. Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* kc, const void* vc, const void* lens,
                                void* out, int b, int hk, int g, int cap, int d, float scale,
                                int dtype, void* stream) {
    if (b <= 0 || hk <= 0 || g <= 0 || cap <= 0 || hk > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (dtype) {
        case DS_F32:
            err = dispatch_d<float>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, s);
            break;
        case DS_F16:
            err = dispatch_d<__half>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, s);
            break;
        case DS_BF16:
            err = dispatch_d<__nv_bfloat16>(q, kc, vc, lens, out, b, hk, g, cap, d, scale, s);
            break;
        default:
            err = cudaErrorInvalidValue;
    }
    return (int)err;
}
