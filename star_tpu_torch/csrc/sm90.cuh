// Hopper (sm_90a) primitives for the port's warp-specialised kernels (K1/K2
// in flash_fwd_sm90.cu and flash_fwd_d512_sm90.cu, K3 in flash_bwd_sm90.cu,
// K5 in fused_tconv3_sm90.cu, K6 and K7 in halo_conv_sm90.cuh), in raw
// PTX:
// mbarriers (also across a cluster), TMA tensor copies (3-D and 4-D,
// 32/64/128-byte swizzle or none, multicast) and bulk copies, their tensor
// maps, wgmma descriptors (swizzled and plain), fences and products, named
// barriers and setmaxnreg.
//
// The tensor map is encoded on the host with cuTensorMapEncodeTiled, found
// through the CUDA runtime's entry-point query, so the library links no
// libcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also expects `bytes` of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// waits until the phase of parity `parity` has completed. A wait that
// outlasts 2^26 tries (far above any real one: each try may suspend the
// thread for a while) traps, so a fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++tries == (1u << 26)) __trap();
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA

// box of a 3-D tensor map at (c0, c1, c2) -> shared memory; completes
// `bytes` on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// the same box into the same offset of every CTA of the cluster in
// `mask`; completes `bytes` on the barrier at `bar`'s offset in each
__device__ __forceinline__ void tma_load_3d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

// box of a 4-D tensor map at (c0, c1, c2, c3) -> shared memory; completes
// `bytes` on `bar`. Coordinates may be negative or past the end: elements
// outside the tensor read as zero.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of global
// memory -> shared memory; completes `bytes` on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// global fp32 at dst += shared fp32 at src, `bytes` (a multiple of 16,
// both 16-byte aligned) by one bulk reduce, committed as its own group
__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk groups (TMA stores, bulk reduces): at most N still
// reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// this thread's bulk groups: at most N not yet complete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared memory -> the box at (c0, c1, c2); elements outside the tensor
// are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// shared memory -> the box of a 4-D tensor map at (c0, c1, c2, c3);
// elements outside the tensor are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// orders this thread's plain shared-memory writes before later async-proxy
// reads (a TMA store, or wgmma reading its operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// clusters

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster arrives and waits (also orders
// the barrier initialisations before the peers' use of them)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::
          : "memory");
}

// one arrival on the barrier at `bar`'s offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

// ---------------------------------------------------------------------------
// named barriers and register reallocation

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma

// Shared-memory matrix descriptor for the 128-byte swizzle: 1024-byte
// atoms of 8 rows x 128 bytes, `sbo` bytes between consecutive 8-row
// atoms, `lbo` bytes between atoms along the leading dimension (read only
// for MN-major operands wider than one atom). Advancing the start address
// by 32 bytes steps 16 bf16 along a K-major row.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// Shared-memory matrix descriptor without swizzle, K-major: core matrices
// of 8 rows x 16 bytes, each 128 contiguous bytes (row r at 16 r), `lbo`
// bytes between the two core matrices of a 16-deep k-step, `sbo` bytes
// between core matrices 8 rows apart. The start needs only 16-byte
// alignment, so a view shifted by one row is a descriptor 16 bytes on.
__device__ __forceinline__ uint64_t desc_plain(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// the byte offset `a` of a row-major tile (rows of 32, 64 or 128 bytes,
// the base aligned to 256, 512 or 1024) under the TMA swizzle of its row
// width: the 16-byte chunk index XOR the row's phase, `rowbytes` / 16 - 1
// masking it
__device__ __forceinline__ uint32_t swizzle(uint32_t a, uint32_t rowbytes) {
  return a ^ (((a >> 7) & (rowbytes / 16 - 1)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins the order of register accesses around asynchronous products: the
// compiler may not move uses of `r` across this point
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#define SM90_F8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_F16 SM90_F8(0), SM90_F8(8)
#define SM90_F32 SM90_F16, SM90_F8(16), SM90_F8(24)
#define SM90_F64                                                      \
  SM90_F32, SM90_F8(32), SM90_F8(40), SM90_F8(48), SM90_F8(56)
#define SM90_F128                                                     \
  SM90_F64, SM90_F8(64), SM90_F8(72), SM90_F8(80), SM90_F8(88),       \
      SM90_F8(96), SM90_F8(104), SM90_F8(112), SM90_F8(120)

// d[64xN] (+)= A[64x16] B[16xN], N in {16, 32, 64, 128, 160, 256}: A
// and B bf16 in
// shared memory, TA / TB their transpose bits (0: K-major, K contiguous;
// 1: MN-major, M or N contiguous); fp32 accumulate; scale_d = 0
// overwrites d. Accumulator layout: warp w of the group holds rows 16w + g
// and 16w + g + 8 (g = lane / 4); register 4i + e holds column
// 8i + 2*(lane % 4) + (e & 1) of row 16w + g (e < 2) or 16w + g + 8.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : SM90_F16
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : SM90_F32
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : SM90_F64
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, "
        "%128, %129, p, 1, 1, %131, %132;\n}\n"
        : SM90_F128
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : SM90_F8(0)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 160) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
        "%71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "%80, %81, p, 1, 1, %83, %84;\n}\n"
        : SM90_F64, SM90_F8(64), SM90_F8(72)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// d[64xN] (+)= A[64x16] B[16xN]: A bf16 from registers (four registers a
// thread in the accumulator's layout: a[0] rows g / columns 2t..2t+1,
// a[1] rows g + 8, a[2] and a[3] the same at columns + 8, so an fp32
// accumulator packs pairwise into the A of the next product), B bf16 in
// shared memory with transpose bit TB; fp32 accumulate.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t* a, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : SM90_F16
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_F32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : SM90_F64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  } else if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : SM90_F128
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(TB));
  }
}

#undef SM90_F128
#undef SM90_F64
#undef SM90_F32
#undef SM90_F16
#undef SM90_F8

// ---------------------------------------------------------------------------
// host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess && p)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A bf16 tensor of `rank` (<= 5) dims (dims[0] contiguous; strides[i] the
// byte stride of dims[i + 1]) read or written in boxes of `box`, with the
// `swizzle`-byte swizzle (32, 64 or 128: box[0] * 2 bytes) or none (0);
// elements outside the tensor read as zero and are not written. Returns
// false where cuTensorMapEncodeTiled refuses it.
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank,
                        const uint64_t* dims, const uint64_t* strides,
                        const uint32_t* box, int swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr || rank < 1 || rank > 5) return false;
  const CUtensorMapSwizzle sw =
      swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                      : CU_TENSOR_MAP_SWIZZLE_NONE;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    unit[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(base), d, s, b, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor of dims {d0, d1, d2} (d0 contiguous; s1, s2 the byte
// strides of d1 and d2) read in boxes of {64, box1, 1}: 128-byte rows under
// the 128-byte swizzle, elements outside the tensor read as zero. Returns
// false where cuTensorMapEncodeTiled refuses it.
inline bool encode_bf16_3d(CUtensorMap* map, const void* base, uint64_t d0,
                           uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2,
                           uint32_t box1) {
  const uint64_t dims[3] = {d0, d1, d2};
  const uint64_t strides[2] = {s1, s2};
  const uint32_t box[3] = {64, box1, 1};
  return encode_bf16(map, base, 3, dims, strides, box, 128);
}

}  // namespace sm90
