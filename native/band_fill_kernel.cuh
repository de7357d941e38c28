// Adaptive-banded semi-global fill for NVIDIA GPUs: the device kernel.
//
// Bit-identical to minialign_jax/dp/band.py make_fill (the reference
// semantics are documented there). GABA's own layout carried to a warp:
// the W-cell anti-diagonal band lives across the lanes of one warp
// (W=64: two cells per lane, W=32: one, W=16: one cell per lane and two
// problems per warp), and every right/down move is one lane shuffle of
// the band vectors. Each problem reads its characters by pointer from
// the device-resident sequence store, 32 characters of lookahead per
// block, and stops on its own X-drop or p-limit.
//
// This header holds only the kernel body. band_fill.cu binds it to the
// XLA FFI; tests/cuda_emu compiles the same body for the host, running
// each warp's lanes as cooperative contexts, so the CPU test suite
// checks the kernel's arithmetic against the XLA reference.
#pragma once

#include <cstdint>

namespace bandfill {

constexpr int BLK = 32;        // steps per block (dp/band.py BLK)
constexpr int NCODE = 4;       // N sentinel code
constexpr int TAIL_N = 96;     // N tail per side (dp/band.py TAIL_N)
constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGE_BYTES = BLK * 64;   // one block of packed cell codes

// cfg attribute layout, shared with minialign_jax/dp/cuda_fill.py
enum {
  CFG_W, CFG_MAX_BLOCKS, CFG_GI, CFG_GE, CFG_GFA, CFG_GFB, CFG_GFA_BND,
  CFG_GFB_BND, CFG_COMBINED, CFG_XDROP, CFG_FLOOR, CFG_INIT_A1, CFG_INIT_B1,
  CFG_MAT, CFG_LEN = CFG_MAT + 25
};

struct Score {
  int gi, ge;
  int gfa, gfb;            // gf step penalties (ScoreParams.gfa_eff/gfb_eff)
  int gfa_bnd, gfb_bnd;    // raw gfa/gfb for the first row/column
  int combined;            // ScoreParams.model == COMBINED
  int xdrop, floor;
  int init_a1, init_b1;    // S at cells (0,1) and (1,0) of the initial band
  int mat[25];             // 5x5 [query base * 5 + ref base], N included
};

struct FillArgs {
  const int8_t* sa; const int32_t* offa; const int32_t* lna;
  const int8_t* sb; const int32_t* offb; const int32_t* lnb;
  int B, max_blocks;
  int32_t* res;            // (4, B): max score, max i, max j, steps
  uint32_t* masks;         // (B, max_blocks, BLK, 16), trace mode only
  uint32_t* dirs;          // (B, max_blocks)
  int32_t* iheads;         // (B, max_blocks)
  int32_t* rprevs;         // (B, max_blocks)
};

inline Score parse_cfg(const int32_t* cfg) {
  Score s;
  s.gi = cfg[CFG_GI]; s.ge = cfg[CFG_GE];
  s.gfa = cfg[CFG_GFA]; s.gfb = cfg[CFG_GFB];
  s.gfa_bnd = cfg[CFG_GFA_BND]; s.gfb_bnd = cfg[CFG_GFB_BND];
  s.combined = cfg[CFG_COMBINED];
  s.xdrop = cfg[CFG_XDROP]; s.floor = cfg[CFG_FLOOR];
  s.init_a1 = cfg[CFG_INIT_A1]; s.init_b1 = cfg[CFG_INIT_B1];
  for (int t = 0; t < 25; ++t) s.mat[t] = cfg[CFG_MAT + t];
  return s;
}

template <int W>
struct Geo {
  static constexpr int CPL = W >= 32 ? W / 32 : 1;   // cells per lane
  static constexpr int G = W / CPL;                  // lanes per problem
  static constexpr int PPW = 32 / G;                 // problems per warp
  static_assert(W == 16 || W == 32 || W == 64, "W must be 16, 32 or 64");
};

// shared memory one warp uses: its copy of the matrix, then one staging
// block of packed cell codes per problem (trace mode)
template <int W, bool TRACE>
__host__ __device__ constexpr int warp_smem_bytes() {
  return 128 + (TRACE ? Geo<W>::PPW * STAGE_BYTES : 0);
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// out[q] = v[q + delta] within the problem's band, `fill` shifted in at
// the edge; delta in {-1, 0, 1}. With two cells per lane delta must be
// uniform across the warp (it is: W=64 is one problem per warp).
template <int W>
__device__ __forceinline__ void shift_cells(const int (&v)[Geo<W>::CPL],
                                            int delta, int fill, int g,
                                            int (&out)[Geo<W>::CPL]) {
  constexpr int G = Geo<W>::G;
  if constexpr (Geo<W>::CPL == 1) {
    const int x = __shfl_sync(FULL, v[0], (g + delta) & (G - 1), G);
    out[0] = (g + delta < 0 || g + delta >= G) ? fill : x;
  } else {
    const int send = delta > 0 ? v[0] : v[1];
    const int x = __shfl_sync(FULL, send, (g + delta) & (G - 1), G);
    if (delta > 0) {
      out[0] = v[1];
      out[1] = g == G - 1 ? fill : x;
    } else if (delta < 0) {
      out[0] = g == 0 ? fill : x;
      out[1] = v[0];
    } else {
      out[0] = v[0];
      out[1] = v[1];
    }
  }
}

template <int W>
__device__ __forceinline__ int group_max(int v) {
  if constexpr (Geo<W>::G == 32) {
    return __reduce_max_sync(FULL, v);
  } else {
    for (int off = Geo<W>::G / 2; off >= 1; off >>= 1)
      v = imax(v, __shfl_xor_sync(FULL, v, off, Geo<W>::G));
    return v;
  }
}

// One warp's share of the batch. s_mat: 25 ints of shared memory;
// s_stage: PPW staging blocks (trace mode).
template <int W, bool TRACE>
__device__ void fill_warp(const FillArgs& A, const Score& sc, int warp_id,
                          int lane, int* s_mat, uint8_t* s_stage) {
  constexpr int CPL = Geo<W>::CPL, G = Geo<W>::G, PPW = Geo<W>::PPW;
  constexpr int C = W / 2;
  const int g = lane % G, grp = lane / G;
  const int prob = warp_id * PPW + grp;
  const bool real = prob < A.B;
  const unsigned gmask = G == 32 ? FULL : (((1u << G) - 1u) << (grp * G));

  for (int t = lane; t < 25; t += 32) s_mat[t] = sc.mat[t];
  if (TRACE) {
    // bytes of lanes beyond W stay zero for the whole fill
    uint32_t* z = reinterpret_cast<uint32_t*>(s_stage);
    for (int t = lane; t < PPW * STAGE_BYTES / 4; t += 32) z[t] = 0;
  }
  __syncwarp();
  uint8_t* stage = s_stage + grp * STAGE_BYTES;

  const int alen = real ? imax(A.lna[prob], 0) : 0;
  const int blen = real ? imax(A.lnb[prob], 0) : 0;
  const int8_t* pa = A.sa + (real ? static_cast<int64_t>(A.offa[prob]) : 0);
  const int8_t* pb = A.sb + (real ? static_cast<int64_t>(A.offb[prob]) : 0);
  const int fl = sc.floor;

  int S[CPL], Sp[CPL], E[CPL], F[CPL], ch[CPL];   // ch: a | b << 8
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int q = g * CPL + k;
    S[k] = q == C - 1 ? sc.init_b1 : (q == C ? sc.init_a1 : fl);
    E[k] = q == C - 1 ? sc.init_b1 : fl;
    F[k] = q == C ? sc.init_a1 : fl;
    Sp[k] = q == C ? 0 : fl;
    const int ai = C - 1 - q, bj = q - C;
    const int ac = (ai >= 0 && ai < alen) ? pa[ai] : NCODE;
    const int bc = (bj >= 0 && bj < blen) ? pb[bj] : NCODE;
    ch[k] = ac | (bc << 8);
  }

  int ihead = C, rprev = 0, p = -1;
  int gmax = 0, gI = 0, gJ = 0, nsteps = 0, cdrop = -128, blk = 0;
  const int plim = imin(alen + blen + 2 * TAIL_N, A.max_blocks * BLK - 2);
  bool alive = real && A.max_blocks > 0;

  while (__any_sync(FULL, alive)) {
    const int ihead0 = ihead, rprev0 = rprev;
    const int jhead0 = (p + 2) - ihead + (W - 1);
    // lookahead slabs: slot t (0..31) is held by lane t % G, register t / G
    int slab[32 / G];
#pragma unroll
    for (int r = 0; r < 32 / G; ++r) {
      const int t = r * G + g;
      const int ai = ihead0 + t, bj = jhead0 + t;
      const int ac = (ai >= 0 && ai < alen) ? pa[ai] : NCODE;
      const int bc = (bj >= 0 && bj < blen) ? pb[bj] : NCODE;
      slab[r] = ac | (bc << 8);
    }
    unsigned dirbits = 0;

    for (int s = 0; s < BLK; ++s) {
      // direction: down iff S[W-1] > S[0]; alternate while ramping in
      const int s0 = __shfl_sync(FULL, S[0], 0, G);
      const int sw = __shfl_sync(FULL, S[CPL - 1], G - 1, G);
      const bool edge_ok = (ihead - (W - 1) >= 0) && ((p + 2) - ihead >= 0);
      const bool down = edge_ok ? (sw > s0) : (((p + 1) & 1) == 1);
      const int delta = down ? 1 : -1;

      // the character entering the band: a[ihead] on a right move,
      // b[jhead + W - 1] on a down move
      const int t = down ? (p + 2) - ihead + (W - 1) - jhead0 : ihead - ihead0;
      const int sendv = (32 / G > 1 && t >= G) ? slab[32 / G - 1] : slab[0];
      const int nv = __shfl_sync(FULL, sendv, t & (G - 1), G);
      const int nxt = down ? (nv >> 8) : (nv & 0xff);

      int Ssh[CPL], EF[CPL], EFsh[CPL], Sdg[CPL], chs[CPL];
      shift_cells<W>(S, delta, fl, g, Ssh);
#pragma unroll
      for (int k = 0; k < CPL; ++k) EF[k] = down ? E[k] : F[k];
      shift_cells<W>(EF, delta, fl, g, EFsh);
      shift_cells<W>(Sp, (down ? 1 : 0) - rprev, fl, g, Sdg);
      shift_cells<W>(ch, delta, nxt | (nxt << 8), g, chs);

      int Sn[CPL], En[CPL], Fn[CPL], chn[CPL], cand[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int sE = down ? Ssh[k] : S[k];     // S at (i-1, j)
        const int sF = down ? S[k] : Ssh[k];     // S at (i, j-1)
        const int eE = down ? EFsh[k] : E[k];
        const int fF = down ? F[k] : EFsh[k];
        En[k] = __viaddmax_s32(sE, -sc.gi, eE) - sc.ge;
        Fn[k] = __viaddmax_s32(sF, -sc.gi, fF) - sc.ge;
        chn[k] = down ? ((ch[k] & 0xff) | (chs[k] & 0xff00))
                      : ((chs[k] & 0xff) | (ch[k] & 0xff00));
        const int sub = s_mat[(chn[k] >> 8) * 5 + (chn[k] & 0xff)];
        int m = __vimax3_s32(En[k], Fn[k], fl);
        m = __viaddmax_s32(sE, -sc.gfb, m);
        m = __viaddmax_s32(sF, -sc.gfa, m);
        Sn[k] = __viaddmax_s32(Sdg[k], sub, m);
        if (TRACE) {
          const int code = (Sn[k] == sF - sc.gfa)
                           | ((Sn[k] == Fn[k]) << 1)
                           | ((Sn[k] == sE - sc.gfb) << 2)
                           | ((Sn[k] == En[k]) << 3)
                           | ((Sn[k] - sc.gi >= Fn[k]) << 4)
                           | ((Sn[k] - sc.gi >= En[k]) << 5);
          const int q = g * CPL + k;
          // dp/band.py _pack_codes: word q % 16, byte q / 16
          stage[s * 64 + 4 * (q & 15) + (q >> 4)] = static_cast<uint8_t>(code);
        }
        cand[k] = Sn[k];
      }

      const int ihn = ihead + (down ? 0 : 1);
      const int pn = p + 1;
      if (ihn - (W - 1) <= 0 || (pn + 2) - ihn <= 0) {
        // the band touches the first row or column of the matrix
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int i = ihn - (g * CPL + k), j = (pn + 2) - i;
          int gaj = -sc.gi * (j > 0) - sc.ge * j;
          int gbi = -sc.gi * (i > 0) - sc.ge * i;
          if (sc.combined) {
            gaj = imax(gaj, -sc.gfa_bnd * j);
            gbi = imax(gbi, -sc.gfb_bnd * i);
          }
          gaj = imax(gaj, fl);
          gbi = imax(gbi, fl);
          const bool on_i0 = i == 0 && j >= 0, on_j0 = j == 0 && i >= 0;
          const bool inv = i < 0 || j < 0;
          if (on_i0) Sn[k] = gaj;
          if (on_j0) Sn[k] = gbi;
          if (inv) Sn[k] = fl;
          if (on_j0) En[k] = gbi;
          if (on_i0 || inv) En[k] = fl;
          if (on_i0) Fn[k] = gaj;
          if (on_j0 || inv) Fn[k] = fl;
          cand[k] = (on_i0 || on_j0 || inv) ? fl : Sn[k];
        }
      }

      // max tracking: strict greater, first cell on ties
      int lm = cand[0], lq = g * CPL;
#pragma unroll
      for (int k = 1; k < CPL; ++k)
        if (cand[k] > lm) { lm = cand[k]; lq = g * CPL + k; }
      if (__any_sync(FULL, alive && lm > gmax)) {
        const int sm = group_max<W>(lm);
        const unsigned bal = __ballot_sync(FULL, lm == sm) & gmask;
        const int arg = __shfl_sync(FULL, lq, (__ffs(bal) - 1) & (G - 1), G);
        if (alive && sm > gmax) {
          gmax = sm;
          gI = ihn - arg;
          gJ = (pn + 2) - gI;
        }
      }

      // X-drop accumulator: saturating fall of the center cell
      int dS[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) dS[k] = Sn[k] - S[k];
      const int dc = __shfl_sync(FULL, dS[C % CPL], C / CPL, G);
      cdrop = imin(imax(cdrop - dc, -128), 127);

#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        Sp[k] = S[k]; S[k] = Sn[k]; E[k] = En[k]; F[k] = Fn[k]; ch[k] = chn[k];
      }
      dirbits |= (down ? 1u : 0u) << s;
      ihead = ihn;
      rprev = down ? 0 : 1;
      p = pn;
      if (alive) ++nsteps;
    }

    if (TRACE) {
      __syncwarp();
      if (alive) {
        const size_t rec = static_cast<size_t>(prob) * A.max_blocks + blk;
        const uint4* src = reinterpret_cast<const uint4*>(stage);
        uint4* dst = reinterpret_cast<uint4*>(A.masks + rec * (BLK * 16));
        for (int t = g; t < STAGE_BYTES / 16; t += G) dst[t] = src[t];
        if (g == 0) {
          A.dirs[rec] = dirbits;
          A.iheads[rec] = ihead0;
          A.rprevs[rec] = rprev0;
        }
      }
      __syncwarp();
    }
    if (alive) {
      ++blk;
      // X-drop test at block end (tx = xdrop - 128), p-limit, capacity
      if (cdrop > sc.xdrop - 128 || p >= plim || blk >= A.max_blocks)
        alive = false;
    }
  }

  if (real && g == 0) {
    A.res[prob] = gmax;
    A.res[A.B + prob] = gI;
    A.res[2 * A.B + prob] = gJ;
    A.res[3 * A.B + prob] = nsteps;
  }
}

}  // namespace bandfill
