// Staging field slots into shared memory with cp.async, for every kernel
// that tests triangles: pairs_trace.cu (B0-B3), pallas_trace.cu (B5, B6)
// and the probes B7a, B7c and B7e of micro_kernel.cu.
//
// A warp stages kPiece slots at a time, one a lane: lane l copies slot l
// of the piece row by row (each row one coalesced 128-byte read) to
// dst[l * kStride + row], slot-major, so that a test reads a slot's 16
// test rows as four broadcast 16-byte loads.  kStride = 20 keeps a slot
// 16-byte aligned and puts a row's 32 writes in 8 banks (4-way), where a
// stride of 16 would put them in 2 (16-way).

#pragma once

namespace {

constexpr int kPiece = 32;   // slots a warp stages at a time: one a lane
constexpr int kStride = 20;  // floats a staged slot: 16 test rows, id, pad

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace
