// XLA FFI binding of the GPU band fill (band_fill_kernel.cuh).
//
// Two targets, called from minialign_jax/dp/cuda_fill.py:
//   MinialignBandFill       (sa, offa, lna, sb, offb, lnb) -> res (4, B)
//   MinialignBandFillTrace  ... -> res, masks, dirs, iheads, rprevs
// The score parameters, W and the block capacity ride in one int32
// array attribute ("cfg", layout in band_fill_kernel.cuh), so new
// scoring options need no rebuild.
//
// Build: make -C native cuda

#include <cuda_runtime.h>

#include <string>

#include "band_fill_kernel.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using namespace bandfill;

namespace {

constexpr int WPB = 4;   // warps per thread block

template <int W, bool TRACE>
__global__ void __launch_bounds__(WPB * 32)
fill_kernel(FillArgs A, Score sc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wid = blockIdx.x * WPB + warp;
  if (wid * Geo<W>::PPW >= A.B) return;
  uint8_t* mine = smem + warp * warp_smem_bytes<W, TRACE>();
  fill_warp<W, TRACE>(A, sc, wid, lane, reinterpret_cast<int*>(mine),
                      mine + 128);
}

template <int W, bool TRACE>
void launch(cudaStream_t stream, const FillArgs& A, const Score& sc) {
  const int warps = (A.B + Geo<W>::PPW - 1) / Geo<W>::PPW;
  const int grid = (warps + WPB - 1) / WPB;
  if (grid == 0) return;
  fill_kernel<W, TRACE><<<grid, WPB * 32,
                          WPB * warp_smem_bytes<W, TRACE>(), stream>>>(A, sc);
}

ffi::Error run(cudaStream_t stream, FillArgs A, ffi::Span<const int32_t> cfg,
               bool trace) {
  if (cfg.size() != CFG_LEN)
    return ffi::Error::InvalidArgument("cfg must hold " +
                                       std::to_string(CFG_LEN) + " values");
  const int W = cfg[CFG_W];
  A.max_blocks = cfg[CFG_MAX_BLOCKS];
  const Score sc = parse_cfg(cfg.begin());
  switch (W * 2 + (trace ? 1 : 0)) {
    case 128: launch<64, false>(stream, A, sc); break;
    case 129: launch<64, true>(stream, A, sc); break;
    case 64: launch<32, false>(stream, A, sc); break;
    case 65: launch<32, true>(stream, A, sc); break;
    case 32: launch<16, false>(stream, A, sc); break;
    case 33: launch<16, true>(stream, A, sc); break;
    default:
      return ffi::Error::InvalidArgument("W must be 16, 32 or 64");
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("band fill launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

FillArgs args(ffi::Buffer<ffi::S8> sa, ffi::Buffer<ffi::S32> offa,
              ffi::Buffer<ffi::S32> lna, ffi::Buffer<ffi::S8> sb,
              ffi::Buffer<ffi::S32> offb, ffi::Buffer<ffi::S32> lnb,
              int32_t* res) {
  FillArgs A{};
  A.sa = sa.typed_data(); A.offa = offa.typed_data(); A.lna = lna.typed_data();
  A.sb = sb.typed_data(); A.offb = offb.typed_data(); A.lnb = lnb.typed_data();
  A.B = static_cast<int>(lna.element_count());
  A.res = res;
  return A;
}

ffi::Error Fill(cudaStream_t stream, ffi::Buffer<ffi::S8> sa,
                ffi::Buffer<ffi::S32> offa, ffi::Buffer<ffi::S32> lna,
                ffi::Buffer<ffi::S8> sb, ffi::Buffer<ffi::S32> offb,
                ffi::Buffer<ffi::S32> lnb, ffi::Span<const int32_t> cfg,
                ffi::ResultBuffer<ffi::S32> res) {
  return run(stream, args(sa, offa, lna, sb, offb, lnb, res->typed_data()),
             cfg, false);
}

ffi::Error FillTrace(cudaStream_t stream, ffi::Buffer<ffi::S8> sa,
                     ffi::Buffer<ffi::S32> offa, ffi::Buffer<ffi::S32> lna,
                     ffi::Buffer<ffi::S8> sb, ffi::Buffer<ffi::S32> offb,
                     ffi::Buffer<ffi::S32> lnb, ffi::Span<const int32_t> cfg,
                     ffi::ResultBuffer<ffi::S32> res,
                     ffi::ResultBuffer<ffi::U32> masks,
                     ffi::ResultBuffer<ffi::U32> dirs,
                     ffi::ResultBuffer<ffi::S32> iheads,
                     ffi::ResultBuffer<ffi::S32> rprevs) {
  FillArgs A = args(sa, offa, lna, sb, offb, lnb, res->typed_data());
  A.masks = masks->typed_data();
  A.dirs = dirs->typed_data();
  A.iheads = iheads->typed_data();
  A.rprevs = rprevs->typed_data();
  return run(stream, A, cfg, true);
}

}  // namespace

#define FILL_BINDING                                       \
  ffi::Ffi::Bind()                                         \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()            \
      .Arg<ffi::Buffer<ffi::S8>>()                         \
      .Arg<ffi::Buffer<ffi::S32>>()                        \
      .Arg<ffi::Buffer<ffi::S32>>()                        \
      .Arg<ffi::Buffer<ffi::S8>>()                         \
      .Arg<ffi::Buffer<ffi::S32>>()                        \
      .Arg<ffi::Buffer<ffi::S32>>()                        \
      .Attr<ffi::Span<const int32_t>>("cfg")               \
      .Ret<ffi::Buffer<ffi::S32>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(MinialignBandFill, Fill, FILL_BINDING);

XLA_FFI_DEFINE_HANDLER_SYMBOL(MinialignBandFillTrace, FillTrace,
                              FILL_BINDING
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
