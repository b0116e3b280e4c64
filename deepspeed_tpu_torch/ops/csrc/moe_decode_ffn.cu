// Selected-expert FFN for MoE decode, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/moe/decode_ffn.py:_kernel
// (launched by the pallas_call in moe_decode_ffn). For each of n tokens
// (n = batch x top-k at a decode step) with expert id idx[i]:
//
//   y_i = act(x_i @ w1[idx_i] + b1[idx_i]) @ w2[idx_i] + b2[idx_i]
//
// x (n, d), stacked w1 (e, d, f), b1 (e, f), w2 (e, f, d), b2 (e, d), all in
// one dtype (f32, fp16 or bf16); idx (n,) int32; y f32 (n, d), gate weights
// applied by the caller. Numerics as in the TPU kernel: both products take
// exact products of the stored values with f32 sums; b1 is added and the
// activation (gelu tanh, relu or silu) applied in f32; h is rounded once to
// the weights' dtype before the second product; b2 is added in f32, then the
// f-blocks' partial outputs in a fixed order. Any n, d, f and e; an expert id
// outside [0, e) is clamped (ids come from an argmax, so this never fires).
//
// What bounds it on this card. Each token reads its expert's w1 and w2 once
// for 4 d f operations: 2 operations a weight element, far below the H100's
// ~295 bf16 operations a byte, so device-memory bytes bound it. At GPT-2
// 125M with 8 experts (d 768, f 3072, bf16), one expert is 9.44 MB: 2.8 us
// at 3.35 TB/s. Tokens that share an expert read its weights once from
// device memory if they run close together; the rest come from the 50 MB L2.
//
// Design. The TPU grid (n, f/bf) adds its f-blocks into one output block in
// sequence; blocks here run in parallel, so:
//
// - moe_ffn_slab, grid (n, cdiv(f, bf)), 256 threads: block (i, j) stages x_i
//   in shared memory as f32, computes h = act(x_i @ w1[idx_i][:, j bf : (j+1)
//   bf] + b1) (each thread owns one 16-byte column vector of the slab and a
//   strided set of its d rows, 8 rows requested before any is used; the
//   row groups meet in shared memory in a fixed order), rounds h to the
//   dtype, and writes the f32 partial h @ w2[idx_i][j bf : (j+1) bf, :] to
//   part (n, cdiv(f, bf), d). w2's slab is one contiguous range, so the block
//   asks L2 to prefetch it before it starts on w1. blockIdx.x is the token,
//   so the blocks of one f-block for all tokens are scheduled together and
//   tokens that share an expert find its slabs in L2.
// - moe_ffn_reduce: y_i = b2[idx_i] + the partials, a block per 32 columns
//   of a token: 8 thread rows each sum every 8th partial, and the 8 sums meet
//   in shared memory in a fixed order (at n = 1 one thread a column, summing
//   all partials in sequence, kept the reduction on 3 SMs). No atomics: the
//   result does not depend on the schedule.
//
// bf is the wrapper's (decode_ffn.py, pick_block_f), from a sweep on the card:
// 32 at n = 1 (96 blocks at d 768, f 3072), 128 at n = 16. 16-byte loads
// where d, f and bf are multiples of 16 bytes of elements and w1, w2 are
// 16-byte aligned, else one element a load.
//
// Later work: grouping tokens by expert in one block, wgmma on grouped tiles,
// a fused reduction, and a CUDA graph of the decode step.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;            // rows a thread requests before it uses them
constexpr int RED_COLS = 32, RED_GROUPS = 8;   // the reduction's block: 32 columns x 8
constexpr int MAX_BLOCK_F = 256;     // so a slab row has at most THREADS column vectors
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr size_t SMEM_MAX = 227 * 1024;

enum DsAct { DS_GELU = 0, DS_RELU = 1, DS_SILU = 2 };

__device__ __forceinline__ float act_fn(float v, int act) {
    if (act == DS_GELU) {   // tanh approximation, as jax.nn.gelu(approximate=True)
        const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
        return 0.5f * v * (1.f + tanhf(inner));
    }
    if (act == DS_RELU) return fmaxf(v, 0.f);
    return v / (1.f + expf(-v));
}

// VEC elements of T as raw storage: one 16-byte load, or one element
template <typename T, int VEC> struct Raw { uint4 u; };
template <typename T> struct Raw<T, 1> { T u; };

template <typename T, int VEC> __device__ __forceinline__ Raw<T, VEC> ldv(const T* p) {
    Raw<T, VEC> r;
    if constexpr (VEC == 1) r.u = p[0];
    else r.u = __ldg(reinterpret_cast<const uint4*>(p));
    return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void fma_vec(float (&acc)[VEC], float s, const Raw<T, VEC>& r) {
    const T* e = reinterpret_cast<const T*>(&r.u);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = fmaf(s, to_f32(e[k]), acc[k]);
}

// acc[k] += sum over rows r = r0, r0 + stride, ... < rows of s[r] * w[r * ld + k]
template <typename T, int VEC>
__device__ __forceinline__ void rows_dot(float (&acc)[VEC], const float* s, const T* w,
                                         int r0, int stride, int rows, size_t ld) {
    int r = r0;
    for (; r + (UNROLL - 1) * stride < rows; r += UNROLL * stride) {
        Raw<T, VEC> raw[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) raw[u] = ldv<T, VEC>(w + (size_t)(r + u * stride) * ld);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) fma_vec<T, VEC>(acc, s[r + u * stride], raw[u]);
    }
    for (; r < rows; r += stride) fma_vec<T, VEC>(acc, s[r], ldv<T, VEC>(w + (size_t)r * ld));
}

__device__ __forceinline__ int expert_of(const int* idx, int i, int e) {
    return min(max(idx[i], 0), e - 1);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
moe_ffn_slab(const T* __restrict__ x, const int* __restrict__ idx, const T* __restrict__ w1,
             const T* __restrict__ b1, const T* __restrict__ w2, float* __restrict__ part,
             int d, int f, int e, int bf, int act) {
    extern __shared__ float smem[];
    float* xs = smem;                 // d: x_i in f32
    float* hs = xs + d;               // bf: h rounded to T, as f32
    float* red = hs + bf;             // THREADS * VEC: partial sums of the row groups
    const int i = blockIdx.x, j = blockIdx.y, nfb = gridDim.y, t = threadIdx.x;
    const int ex = expert_of(idx, i, e);
    const int f0 = j * bf;
    const int nf = min(bf, f - f0);

    // w2's slab, rows [f0, f0 + nf) of d: one contiguous range; into L2 now
    const T* w2e = w2 + ((size_t)ex * f + f0) * d;
    {
        const char* p = reinterpret_cast<const char*>(w2e);
        const size_t bytes = (size_t)nf * d * sizeof(T);
        for (size_t off = (size_t)t * 128; off < bytes; off += (size_t)THREADS * 128)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(p + off));
    }
    for (int c = t; c < d; c += THREADS) xs[c] = to_f32(x[(size_t)i * d + c]);
    __syncthreads();

    // h = x_i @ w1[ex][:, f0 : f0 + nf]: thread (g, c) sums column vector c
    // over rows g, g + G, ...
    {
        const int cv = nf / VEC;                  // nf is a multiple of VEC
        const int G = THREADS / cv;
        const int g = t / cv, c = t % cv;
        if (g < G) {
            float acc[VEC] = {};
            rows_dot<T, VEC>(acc, xs, w1 + (size_t)ex * d * f + f0 + c * VEC, g, G, d, f);
#pragma unroll
            for (int k = 0; k < VEC; ++k) red[g * nf + c * VEC + k] = acc[k];
        }
        __syncthreads();
        for (int col = t; col < nf; col += THREADS) {
            float s = 0.f;
            for (int gg = 0; gg < G; ++gg) s += red[gg * nf + col];
            s += to_f32(b1[(size_t)ex * f + f0 + col]);
            hs[col] = round_to<T>(act_fn(s, act));
        }
        __syncthreads();
    }

    // part[i, j] = h @ w2[ex][f0 : f0 + nf, :]
    float* dst = part + ((size_t)i * nfb + j) * d;
    const int cvd = d / VEC;                      // d is a multiple of VEC
    if (cvd >= THREADS) {
        for (int c = t; c < cvd; c += THREADS) {
            float acc[VEC] = {};
            rows_dot<T, VEC>(acc, hs, w2e + c * VEC, 0, 1, nf, d);
#pragma unroll
            for (int k = 0; k < VEC; ++k) dst[c * VEC + k] = acc[k];
        }
    } else {
        const int G = THREADS / cvd;
        const int g = t / cvd, c = t % cvd;
        if (g < G) {
            float acc[VEC] = {};
            rows_dot<T, VEC>(acc, hs, w2e + c * VEC, g, G, nf, d);
#pragma unroll
            for (int k = 0; k < VEC; ++k) red[g * d + c * VEC + k] = acc[k];
        }
        __syncthreads();
        for (int col = t; col < d; col += THREADS) {
            float s = 0.f;
            for (int gg = 0; gg < G; ++gg) s += red[gg * d + col];
            dst[col] = s;
        }
    }
}

// y[i, col] = b2[idx_i, col] + the sums over g of (the sum over the f-blocks
// j = g, g + 8, ..., in order, of part[i, j, col]), g in order
template <typename T>
__global__ void __launch_bounds__(RED_COLS * RED_GROUPS)
moe_ffn_reduce(const float* __restrict__ part, const int* __restrict__ idx,
               const T* __restrict__ b2, float* __restrict__ y, int d, int e, int nfb) {
    __shared__ float sums[RED_GROUPS][RED_COLS];
    const int i = blockIdx.y, c = threadIdx.x, g = threadIdx.y;
    const int col = blockIdx.x * RED_COLS + c;
    const int nfb_used = nfb;
    float s = 0.f;
    if (col < d) {
        const float* p = part + (size_t)i * nfb * d + col;
        for (int j = g; j < nfb_used; j += RED_GROUPS) s += p[(size_t)j * d];
    }
    sums[g][c] = s;
    __syncthreads();
    if (g == 0 && col < d) {
        float t = to_f32(b2[(size_t)expert_of(idx, i, e) * d + col]);
        for (int gg = 0; gg < RED_GROUPS; ++gg) t += sums[gg][c];
        y[(size_t)i * d + col] = t;
    }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const int* idx, const void* w1, const void* b1,
                   const void* w2, const void* b2, float* part, float* y, int n, int d, int f,
                   int e, int bf, int act, cudaStream_t stream) {
    const int nfb = (f + bf - 1) / bf;
    if (nfb > 65535) return cudaErrorInvalidValue;
    const size_t smem = (size_t)(d + bf + THREADS * VEC) * sizeof(float);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    if (smem > SMEM_DEFAULT) {
        cudaError_t err = cudaFuncSetAttribute(
            reinterpret_cast<const void*>(&moe_ffn_slab<T, VEC>),
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    moe_ffn_slab<T, VEC><<<dim3(n, nfb), THREADS, smem, stream>>>(
        static_cast<const T*>(x), idx, static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(w2), part, d, f, e, bf, act);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    moe_ffn_reduce<T><<<dim3((d + RED_COLS - 1) / RED_COLS, n), dim3(RED_COLS, RED_GROUPS), 0,
                        stream>>>(
        part, idx, static_cast<const T*>(b2), y, d, e, nfb);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const int* idx, const void* w1, const void* b1,
                     const void* w2, const void* b2, float* part, float* y, int n, int d, int f,
                     int e, int bf, int act, cudaStream_t stream) {
    constexpr int V = 16 / (int)sizeof(T);
    const bool vec = d % V == 0 && f % V == 0 && bf % V == 0 &&
                     (uintptr_t)w1 % 16 == 0 && (uintptr_t)w2 % 16 == 0;
    if (vec) return launch<T, V>(x, idx, w1, b1, w2, b2, part, y, n, d, f, e, bf, act, stream);
    return launch<T, 1>(x, idx, w1, b1, w2, b2, part, y, n, d, f, e, bf, act, stream);
}

}  // namespace

// x (n, d), w1 (e, d, f), b1 (e, f), w2 (e, f, d), b2 (e, d): contiguous, in
// `dtype`; idx (n,) int32; part: f32 scratch of n * cdiv(f, block_f) * d;
// y: f32 (n, d). act: 0 gelu (tanh), 1 relu, 2 silu. block_f in [1, 256].
// Launches the slab kernel and the reduction on `stream`; returns
// cudaGetLastError().
extern "C" int moe_decode_ffn(const void* x, const void* idx, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* part, void* y, int n, int d,
                              int f, int e, int block_f, int act, int dtype, void* stream) {
    if (n <= 0 || d <= 0 || f <= 0 || e <= 0 || block_f < 1 || block_f > MAX_BLOCK_F ||
        act < DS_GELU || act > DS_SILU)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* ip = static_cast<const int*>(idx);
    float* pp = static_cast<float*>(part);
    float* yp = static_cast<float*>(y);
    switch (dtype) {
        case DS_F32:
            return (int)dispatch<float>(x, ip, w1, b1, w2, b2, pp, yp, n, d, f, e, block_f, act,
                                        st);
        case DS_F16:
            return (int)dispatch<__half>(x, ip, w1, b1, w2, b2, pp, yp, n, d, f, e, block_f, act,
                                         st);
        case DS_BF16:
            return (int)dispatch<__nv_bfloat16>(x, ip, w1, b1, w2, b2, pp, yp, n, d, f, e,
                                                block_f, act, st);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
