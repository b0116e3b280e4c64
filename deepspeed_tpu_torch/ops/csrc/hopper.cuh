// Hopper (sm_90a) building blocks of the flash kernels' bf16/fp16 paths: TMA
// tensor maps and loads, mbarriers, wgmma descriptors and the m64n64k16 wgmma
// with f32 accumulators, A from shared memory or from registers.
//
// Tiles live in shared memory as 64 x 64 panels of 16-bit values (8 KB, 1024-
// byte aligned), each row one 128-byte line in the 128-byte swizzle that a TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B writes. A head dim of 128 is two panels.
//
// Tensor maps are encoded on the host inside each C entry point.
// cuTensorMapEncodeTiled (libcuda) is reached through cudaGetDriverEntryPoint,
// so the libraries link against the CUDA runtime only (no -lcuda); <cuda.h>
// gives the types.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace hopper {

constexpr int PANEL = 64;                          // rows and columns of a panel
constexpr int PANEL_BYTES = PANEL * PANEL * 2;     // 8 KB of 16-bit values
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult status;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) ==
                cudaSuccess &&
            status == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// A 3-D map over a contiguous (bh, t, d) tensor of 16-bit values, boxes of
// box_rows rows (64, or 16 or 32 for a block-sparse stage's part of a panel:
// a multiple of 8 rows keeps each box on a 1024-byte swizzle boundary) x 64
// columns of one (b*h). Rows past t lie outside the map, so a box that
// reaches past t is zero-filled: a ragged last tile never reads the next
// head's rows.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* base, int bh, int t, int d,
                               bool bf16, int box_rows = PANEL) {
    EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
    const cuuint32_t box[3] = {PANEL, (cuuint32_t)box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUtensorMapDataType type =
        bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
    CUresult r = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
}

// waits until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// one box of the map at (column c0, row c1, head c2) into shared memory at dst
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// one contiguous run of `bytes` bytes from global memory at src into shared
// memory at dst, completing on the mbarrier at bar: a bulk copy, no tensor
// map. bytes is a multiple of 16 and both addresses are 16-byte aligned.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// register rebalancing between producer and consumer warpgroups;
// -DDS_NO_SETMAXNREG builds without it, to time what it buys
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
#ifndef DS_NO_SETMAXNREG
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
#endif
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
#ifndef DS_NO_SETMAXNREG
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
#endif
}

// wgmma matrix descriptor of a 128-byte-swizzled operand at shared address
// `addr`: 8-row groups 1024 bytes apart (SBO); `lbo` bytes between 64-column
// chunks of an MN-major operand (unused where the operand is one chunk wide).
// K-major operands step k by 32 bytes inside the swizzled line, MN-major ones
// by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo = 16) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DS_WG_D32                                                                              \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DS_WG_OUT32(d)                                                                         \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
        "+f"(d[31])

// D (64 x 64 f32, accumulator fragments) += A (64 x 16, shared, K-major) *
// B (16 x 64, shared; TRANS_B 0: K-major, 1: MN-major); D = A * B where !acc
template <typename T, int TRANS_B>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, bool acc) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DS_WG_D32
            ", %32, %33, p, 1, 1, 0, %35;\n}"
            : DS_WG_OUT32(d)
            : "l"(da), "l"(db), "r"((int)acc), "n"(TRANS_B));
    } else {
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " DS_WG_D32
            ", %32, %33, p, 1, 1, 0, %35;\n}"
            : DS_WG_OUT32(d)
            : "l"(da), "l"(db), "r"((int)acc), "n"(TRANS_B));
    }
}

// D (64 x 64 f32) += A (64 x 16, registers: a[4] in the m16n8k16 A-fragment
// order of each warp's 16 rows) * B (16 x 64, shared, MN-major when TRANS_B)
template <typename T, int TRANS_B>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DS_WG_D32
            ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}"
            : DS_WG_OUT32(d)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
    } else {
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " DS_WG_D32
            ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}"
            : DS_WG_OUT32(d)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
    }
}

// The dequant-GEMM's shapes: m64nNk16 with A from registers (the m16n8k16
// A-fragment order, as mma_rs) and B K-major in shared memory, N = 8 or 16
// (decode) or 128 (prefill); D is N / 2 f32 fragments, element 4j + e at row
// 16w + l/4 + 8*(e >= 2), column 8j + 2*(l%4) + (e & 1).
#define DS_WG_D4 "{%0, %1, %2, %3}"
#define DS_WG_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define DS_WG_D64                                                                             \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
    "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
    "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define DS_WG_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define DS_WG_F8(d, i) DS_WG_F4(d, i), DS_WG_F4(d, i + 4)
#define DS_WG_F64(d)                                                                          \
    DS_WG_F8(d, 0), DS_WG_F8(d, 8), DS_WG_F8(d, 16), DS_WG_F8(d, 24), DS_WG_F8(d, 32),        \
        DS_WG_F8(d, 40), DS_WG_F8(d, 48), DS_WG_F8(d, 56)
// A's registers are operands A0..A3, B's descriptor B, the accumulate flag P
#define DS_WG_RS_K(SHAPE, TY, DSTR, A0, A1, A2, A3, B, P, OUTS)                                \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " P ", 0;\n"                             \
                 "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " " DSTR ", {" A0     \
                 ", " A1 ", " A2 ", " A3 "}, " B ", p, 1, 1, 0;\n}"                           \
                 : OUTS                                                                        \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"((int)acc))

// D (64 x N f32) += A (64 x 16, registers) * B (16 x N, shared, K-major);
// D = A * B where !acc
template <typename T, int N>
__device__ __forceinline__ void mma_rs_k(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         bool acc) {
    static_assert(N == 8 || N == 16 || N == 128, "m64nNk16 with N 8, 16 or 128");
    constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
    if constexpr (N == 8) {
        if constexpr (BF)
            DS_WG_RS_K("m64n8k16", "bf16", DS_WG_D4, "%4", "%5", "%6", "%7", "%8", "%9",
                       DS_WG_F4(d, 0));
        else
            DS_WG_RS_K("m64n8k16", "f16", DS_WG_D4, "%4", "%5", "%6", "%7", "%8", "%9",
                       DS_WG_F4(d, 0));
    } else if constexpr (N == 16) {
        if constexpr (BF)
            DS_WG_RS_K("m64n16k16", "bf16", DS_WG_D8, "%8", "%9", "%10", "%11", "%12", "%13",
                       DS_WG_F8(d, 0));
        else
            DS_WG_RS_K("m64n16k16", "f16", DS_WG_D8, "%8", "%9", "%10", "%11", "%12", "%13",
                       DS_WG_F8(d, 0));
    } else {
        if constexpr (BF)
            DS_WG_RS_K("m64n128k16", "bf16", DS_WG_D64, "%64", "%65", "%66", "%67", "%68", "%69",
                       DS_WG_F64(d));
        else
            DS_WG_RS_K("m64n128k16", "f16", DS_WG_D64, "%64", "%65", "%66", "%67", "%68", "%69",
                       DS_WG_F64(d));
    }
}

// two f32 values rounded to T and packed low-first: one 32-bit A-fragment
// register, or one store of two neighbouring columns
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// two packed T values (low first) back in f32
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t v);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
    return __half22float2(*reinterpret_cast<__half2*>(&v));
}

// The accumulator fragment of m64nNk16, thread (warp w, lane l) of the
// warpgroup: element 4j + e sits at row 16w + l/4 + 8*(e >= 2), column
// 8j + 2*(l%4) + (e & 1). Columns 16kk .. 16kk+15 of it, rounded to T, are
// the A fragment of k-step kk of the next product.
template <typename T>
__device__ __forceinline__ void acc_to_afrag(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        a[kk][0] = pack2<T>(d[8 * kk + 0], d[8 * kk + 1]);
        a[kk][1] = pack2<T>(d[8 * kk + 2], d[8 * kk + 3]);
        a[kk][2] = pack2<T>(d[8 * kk + 4], d[8 * kk + 5]);
        a[kk][3] = pack2<T>(d[8 * kk + 6], d[8 * kk + 7]);
    }
}

// acc_to_afrag without losing the f32 value: hi holds each element rounded
// to T, lo the rest (x - hi, exact in f32) rounded to T, so the two A
// operands' products summed into one f32 accumulator keep ~16 (bf16) or ~22
// (fp16) bits of each element
template <typename T>
__device__ __forceinline__ void acc_to_afrag_split(const float (&d)[32], uint32_t (&hi)[4][4],
                                                   uint32_t (&lo)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const float a = d[8 * kk + 2 * r], b = d[8 * kk + 2 * r + 1];
            hi[kk][r] = pack2<T>(a, b);
            const float2 h = unpack2<T>(hi[kk][r]);
            lo[kk][r] = pack2<T>(a - h.x, b - h.y);
        }
}

}  // namespace hopper
