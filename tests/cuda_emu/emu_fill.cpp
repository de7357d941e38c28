// The GPU band fill kernel compiled for the host (see shim.h), exposed
// as XLA FFI CPU targets with the same signature as native/band_fill.cu,
// so minialign_jax/dp/cuda_fill.py's wrapper runs unchanged on the CPU
// test backend.
#include "shim.h"

#include <string>
#include <vector>

#include "band_fill_kernel.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using namespace bandfill;

namespace {

template <int W, bool TRACE>
void emulate(const FillArgs& A, const Score& sc) {
  constexpr int PPW = Geo<W>::PPW;
  const int warps = (A.B + PPW - 1) / PPW;
  std::vector<uint8_t> smem(warp_smem_bytes<W, TRACE>() + 16);
  for (int wid = 0; wid < warps; ++wid) {
    emu::run_warp([&](int lane) {
      fill_warp<W, TRACE>(A, sc, wid, lane, reinterpret_cast<int*>(smem.data()),
                          smem.data() + 128);
    });
  }
}

ffi::Error run(FillArgs A, ffi::Span<const int32_t> cfg, bool trace) {
  if (cfg.size() != CFG_LEN)
    return ffi::Error::InvalidArgument("cfg must hold " +
                                       std::to_string(CFG_LEN) + " values");
  const int W = cfg[CFG_W];
  A.max_blocks = cfg[CFG_MAX_BLOCKS];
  const Score sc = parse_cfg(cfg.begin());
  switch (W * 2 + (trace ? 1 : 0)) {
    case 128: emulate<64, false>(A, sc); break;
    case 129: emulate<64, true>(A, sc); break;
    case 64: emulate<32, false>(A, sc); break;
    case 65: emulate<32, true>(A, sc); break;
    case 32: emulate<16, false>(A, sc); break;
    case 33: emulate<16, true>(A, sc); break;
    default:
      return ffi::Error::InvalidArgument("W must be 16, 32 or 64");
  }
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

ffi::Error Fill(ffi::Buffer<ffi::S8> sa, ffi::Buffer<ffi::S32> offa,
                ffi::Buffer<ffi::S32> lna, ffi::Buffer<ffi::S8> sb,
                ffi::Buffer<ffi::S32> offb, ffi::Buffer<ffi::S32> lnb,
                ffi::Span<const int32_t> cfg,
                ffi::ResultBuffer<ffi::S32> res) {
  return run(args(sa, offa, lna, sb, offb, lnb, res->typed_data()), cfg,
             false);
}

ffi::Error FillTrace(ffi::Buffer<ffi::S8> sa, ffi::Buffer<ffi::S32> offa,
                     ffi::Buffer<ffi::S32> lna, ffi::Buffer<ffi::S8> sb,
                     ffi::Buffer<ffi::S32> offb, ffi::Buffer<ffi::S32> lnb,
                     ffi::Span<const int32_t> cfg,
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
  return run(A, cfg, true);
}

}  // namespace

#define FILL_BINDING                             \
  ffi::Ffi::Bind()                               \
      .Arg<ffi::Buffer<ffi::S8>>()               \
      .Arg<ffi::Buffer<ffi::S32>>()              \
      .Arg<ffi::Buffer<ffi::S32>>()              \
      .Arg<ffi::Buffer<ffi::S8>>()               \
      .Arg<ffi::Buffer<ffi::S32>>()              \
      .Arg<ffi::Buffer<ffi::S32>>()              \
      .Attr<ffi::Span<const int32_t>>("cfg")     \
      .Ret<ffi::Buffer<ffi::S32>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(MinialignBandFill, Fill, FILL_BINDING);

XLA_FFI_DEFINE_HANDLER_SYMBOL(MinialignBandFillTrace, FillTrace,
                              FILL_BINDING
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
