// Host stand-ins for the CUDA warp primitives band_fill_kernel.cuh uses.
//
// A warp's 32 lanes run as cooperative ucontext coroutines on one host
// thread. Every warp-collective call is a sync point: the lane deposits
// its value and yields; once all 32 lanes have reached the same sync
// point the scheduler snapshots the deposits and resumes them in order,
// so each lane reads exactly what the hardware would deliver. The
// kernel's control flow is warp-synchronous, which this relies on (and
// checks: lanes that finish at different sync points abort).
#pragma once

#include <ucontext.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x) alignas(x)

struct uint4 {
  unsigned x, y, z, w;
};

namespace emu {

struct Warp {
  ucontext_t sched;
  ucontext_t ctx[32];
  std::vector<char> stack[32];
  std::function<void(int)> body;
  long long dep[32];
  long long snap[32];
  bool done[32];
  int cur = 0;
};

inline thread_local Warp* tl_warp = nullptr;

inline void lane_entry(int lane) {
  Warp* w = tl_warp;
  w->body(lane);
  w->done[lane] = true;
}

// Run body(lane) for 32 lanes as one warp.
inline void run_warp(const std::function<void(int)>& body) {
  Warp w;
  w.body = body;
  Warp* prev = tl_warp;
  tl_warp = &w;
  for (int l = 0; l < 32; ++l) {
    w.done[l] = false;
    w.stack[l].resize(1 << 18);
    getcontext(&w.ctx[l]);
    w.ctx[l].uc_stack.ss_sp = w.stack[l].data();
    w.ctx[l].uc_stack.ss_size = w.stack[l].size();
    w.ctx[l].uc_link = &w.sched;
    makecontext(&w.ctx[l], reinterpret_cast<void (*)()>(lane_entry), 1, l);
  }
  for (;;) {
    for (int l = 0; l < 32; ++l) {
      w.cur = l;
      swapcontext(&w.sched, &w.ctx[l]);
    }
    int n_done = 0;
    for (int l = 0; l < 32; ++l) n_done += w.done[l];
    if (n_done == 32) break;
    if (n_done != 0) {
      std::fprintf(stderr, "emu: warp lanes diverged at a sync point\n");
      std::abort();
    }
    std::copy(w.dep, w.dep + 32, w.snap);
  }
  tl_warp = prev;
}

inline int lane_id() { return tl_warp->cur; }

// deposit v, wait for the other lanes; returns this lane's id
inline int sync_point(long long v) {
  Warp* w = tl_warp;
  const int l = w->cur;
  w->dep[l] = v;
  swapcontext(&w->ctx[l], &w->sched);
  return l;
}

}  // namespace emu

template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int l = emu::sync_point(v);
  return static_cast<T>(
      emu::tl_warp->snap[(l & ~(width - 1)) + (src & (width - 1))]);
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  const int l = emu::sync_point(v);
  return static_cast<T>(
      emu::tl_warp->snap[(l & ~(width - 1)) + ((l ^ mask) & (width - 1))]);
}

inline unsigned __ballot_sync(unsigned, int pred) {
  emu::sync_point(pred != 0);
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l)
    if (emu::tl_warp->snap[l]) bits |= 1u << l;
  return bits;
}

inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0; }

inline int __reduce_max_sync(unsigned, int v) {
  emu::sync_point(v);
  long long m = emu::tl_warp->snap[0];
  for (int l = 1; l < 32; ++l) m = std::max(m, emu::tl_warp->snap[l]);
  return static_cast<int>(m);
}

inline void __syncwarp(unsigned = 0xffffffffu) { emu::sync_point(0); }

inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }

inline int __viaddmax_s32(int a, int b, int c) { return std::max(a + b, c); }

inline int __vimax3_s32(int a, int b, int c) { return std::max(a, std::max(b, c)); }
