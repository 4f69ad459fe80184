// Head-dim classes of the flash-attention kernels of this directory, shared
// by the float32 kernels (mma_tf32x3.cuh: 32-column classes) and the bf16
// kernels (wgmma_bf16.cuh: 64-column panels).
//
// A kernel is instantiated for a few classes DH and runs a head dim dh with
// its class's tiles: 16 and 32 as they are, and every dh % 8 == 0 from 64
// to 256 rounded up to a whole number of PANEL columns. The columns at or
// past dh load as zeros (cp.async with a zero source size, or TMA's
// out-of-bounds fill): they add nothing to S, dP or D and give zero output
// columns, which are not stored.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace gordo_flash {

// The class of dh for PANEL-column classes; 0 for a dh the kernels do not take
template <int PANEL>
inline int head_dim_class(int dh) {
  if (dh == 16 || dh == 32) return dh;
  if (dh % 8 != 0 || dh < 64 || dh > 256) return 0;
  return (dh + PANEL - 1) / PANEL * PANEL;
}

// Whether class DH takes a dh below it (from 96 on: 64 takes only 64)
constexpr bool has_padded_dims(int DH) { return DH > 64; }

// dh as an instantiation of class DH uses it: DH itself in the exact one
// (compiled with DH as a constant: constant strides, no column tests), the
// caller's dh in the padded one
template <int DH, bool PADDED>
__device__ __forceinline__ int head_dim(int dh) {
  return PADDED ? dh : DH;
}

// fn(std::bool_constant<PADDED>{}) for the instantiation of class DH that
// runs dh: the exact one in a class that takes no dh below it, the padded
// one in a class that does, unless EXACT_TOO gives the class an exact one
// for the dh that fills it as well
template <int DH, bool EXACT_TOO, typename Fn>
auto with_instantiation(int dh, Fn&& fn) {
  if constexpr (!has_padded_dims(DH)) {
    return fn(std::false_type{});
  } else if constexpr (!EXACT_TOO) {
    return fn(std::true_type{});
  } else {
    return dh == DH ? fn(std::false_type{}) : fn(std::true_type{});
  }
}

template <int PANEL, int DH, typename Fn>
cudaError_t with_panel_class(int c, Fn&& fn) {
  if (c == DH) return fn(std::integral_constant<int, DH>{});
  if constexpr (DH + PANEL <= 256) {
    return with_panel_class<PANEL, DH + PANEL>(c, fn);
  } else {
    return cudaErrorInvalidValue;
  }
}

// fn(std::integral_constant<int, DH>{}) for the class DH of dh, or
// cudaErrorInvalidValue where dh has none
template <int PANEL, typename Fn>
cudaError_t with_head_dim_class(int dh, Fn&& fn) {
  const int c = head_dim_class<PANEL>(dh);
  if (c == 16) return fn(std::integral_constant<int, 16>{});
  if (c == 32) return fn(std::integral_constant<int, 32>{});
  return with_panel_class<PANEL, 64>(c, fn);
}

}  // namespace gordo_flash
