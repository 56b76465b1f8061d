// Fused tick-phase routing step for Hopper (sm_90a), float64 throughout.
//
// Replaces the TPU kernel src/repro/kernels/tick_phase/kernel.py::_phase_kernel
// (one pallas_call per routing phase of the seed-batched chaos tick). Contract
// and numerics: src/repro_torch/kernels/tick_phase/ref.py (tick_phase_ref),
// term for term — the same epsilons, the same selects, pads adding +0.0 to row
// sums and +inf to row minima, each row summed in its stored member order.
//
// What bounds it on the card: bytes. One phase is a chain of dependent gathers
// and short row reductions over ragged row tables, a few float64 operations
// per byte. At phase 0 of the 100k-task mixed arena with S = 8 (D = 30000 dst
// entries, E = 3750 edges) the gathered task rows, the tables and the outputs
// come to roughly 10-15 MB per launch, a few microseconds at 3.35 TB/s, so
// launch and host overhead dominate at first.
//
// Why the TPU design does not carry over: the TPU kernel keeps whole
// (sb, n_tasks) rows plus two (sb, D) scratch rows in VMEM across its fused
// stages. At 100k tasks one float64 task row is 800 KB, more than a block's
// 227 KB of shared memory, and CUDA blocks run in parallel with nothing carried
// between them. So every reduction whose inputs come from an earlier stage gets
// its own launch, all five on the caller's stream:
//   1. row sums over the inputs only: tot_slot (s rows), prod_blk (bs rows),
//      alive_blk (br rows), capsum / capsum_fb (gr rows);
//   2. rs per edge over the er rows, recomputing val_nrm inline;
//   3. per dst entry: arriving, dropped and the head-of-line ratio;
//   4. row minima: lam_e over the er rows, lam_b over the br rows;
//   5. per edge row: accepted for its members and overflow as their sum (the
//      er rows partition the D axis; the wrapper checks that at pack time).
// One thread per (seed, row) or (seed, entry): deterministic, no atomics, and
// the member order of every row sum is preserved. The intermediates live in one
// workspace that the wrapper allocates; the kernel allocates nothing and does
// not synchronise. Fusing stages, shared memory for short rows, more seeds per
// thread and graph capture of the tick are left for later work.
//
// NaN hazard: the reference computes a 0/0 for weakhash dummy entries and then
// selects it away, so everything here selects (c ? a : b) and never multiplies
// by a mask; min/max are plain comparisons, not fmin/fmax.
//
// Built with -fmad=false (see kernel.py): no multiply-add contraction, so each
// product and sum rounds as in the plain version.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// operand order of tick_phase_launch (kernel.py PTRS / DIMS)
enum Ptr {
  P_PRODUCED, P_ALIVE, P_FREE, P_MS, P_DI, P_DF, P_S_IDX, P_S_MASK, P_SOE,
  P_ER_IDX, P_ER_MASK, P_GR_IDX, P_GR_MASK, P_BR_IDX, P_BR_MASK, P_BS_IDX,
  P_BS_MASK, P_WORK, P_ACCEPTED, P_DROPPED, P_OVERFLOW
};
enum Dim {
  D_S, D_NTASKS, D_D, D_E, D_RS, D_LS, D_LE, D_G1, D_LG, D_B1, D_LB, D_LBS,
  D_HAS_BLK, D_HAS_GRP
};
// packed table rows (ops.py DI_ROWS / DF_ROWS)
enum { DI_DST, DI_FWD_SRC, DI_EDGE_OF, DI_GRP_OF, DI_BLK_OF };
enum {
  DF_M_FWD, DF_M_BLK, DF_M_HASH, DF_M_WH, DF_M_BK, DF_IS_NORM, DF_M_ACC_S,
  DF_M_ACC_B, DF_DINB, DF_SHARE, DF_MASS, DF_QCAP
};

constexpr int kThreads = 256;

struct Phase {
  const double *produced, *alive, *free_, *ms;     // (S, n)
  const int *di;                                   // (5, D)
  const double *df;                                // (12, D)
  const int *s_idx; const double *s_mask;          // (Rs, Ls)
  const int *soe;                                  // (E,)
  const int *er_idx; const double *er_mask;        // (E, Le)
  const int *gr_idx; const double *gr_mask;        // (G1, Lg)
  const int *br_idx; const double *br_mask;        // (B1, Lb)
  const int *bs_idx; const double *bs_mask;        // (B1, Lbs)
  // workspace rows, each (S, ·)
  double *tot_slot, *prod_blk, *alive_blk, *lam_b, *capsum, *capsum_fb, *rs,
      *lam_e, *arr, *ratio;
  double *accepted, *dropped, *overflow;           // (S, D), (S, D), (S, E)
  long long S, n, D, E, Rs, Ls, Le, G1, Lg, B1, Lb, Lbs;
  bool has_blk, has_grp;

  __device__ double dfv(int row, long long j) const { return df[row * D + j]; }
  __device__ long long dix(int row, long long j) const { return di[row * D + j]; }
};

__device__ __forceinline__ double max_(double a, double b) { return a > b ? a : b; }
__device__ __forceinline__ double min_(double a, double b) { return a < b ? a : b; }

__device__ __forceinline__ long long tid() {
  return blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
}

// sum of vals[idx[l]] * mask[l] in member order (an arena row gather)
__device__ double row_sum(const double* vals, const int* idx, const double* mask,
                          long long L) {
  double acc = 0.0;
  for (long long l = 0; l < L; ++l) acc += vals[idx[l]] * mask[l];
  return acc;
}

// min over the row of (mask > 0.5 ? vals[idx] : +inf)
__device__ double row_min(const double* vals, const int* idx, const double* mask,
                          long long L) {
  double m = CUDART_INF;
  for (long long l = 0; l < L; ++l) {
    const double v = mask[l] > 0.5 ? vals[idx[l]] : CUDART_INF;
    m = v < m ? v : m;
  }
  return m;
}

// normalised routing weight of dst entry j for seed s (weakhash / backlog /
// uniform), times is_norm; needs the stage-1 capsum rows when has_grp
__device__ double val_nrm(const Phase& p, long long s, long long j) {
  const long long t = p.dix(DI_DST, j);
  const double alive_d = p.alive[s * p.n + t];
  const double free_d = p.free_[s * p.n + t];
  double v;
  if (p.dfv(DF_M_WH, j) > 0.5) {
    if (p.has_grp) {
      const long long g = p.dix(DI_GRP_OF, j);
      const double cs = p.capsum[s * p.G1 + g];
      const bool fall = cs <= 0.0;
      const double cap_w = max_(free_d, 1e-9) * alive_d;
      const double cap2 = (fall ? alive_d + 1e-9 : cap_w) * alive_d;
      const double cs2 = fall ? p.capsum_fb[s * p.G1 + g] : cs;
      v = cap2 * p.dfv(DF_MASS, j) / cs2;
    } else {
      v = 0.0;
    }
  } else if (p.dfv(DF_M_BK, j) > 0.5) {
    const double open = free_d > p.dfv(DF_QCAP, j) * 0.25 ? 1.0 : 0.0;
    v = max_(free_d, 1e-9) * alive_d * max_(open, 0.05);
  } else {
    v = alive_d;
  }
  return v * p.dfv(DF_IS_NORM, j);
}

// stage 1: row sums that read only the inputs
__global__ void k_input_rows(Phase p) {
  const long long rows = p.Rs + (p.has_blk ? 2 * p.B1 : 0)
                         + (p.has_grp ? p.G1 : 0);
  const long long i = tid();
  if (i >= p.S * rows) return;
  const long long s = i / rows;
  long long r = i % rows;
  const double* prod = p.produced + s * p.n;
  if (r < p.Rs) {
    p.tot_slot[s * p.Rs + r] =
        row_sum(prod, p.s_idx + r * p.Ls, p.s_mask + r * p.Ls, p.Ls);
    return;
  }
  r -= p.Rs;
  if (p.has_blk) {
    if (r < p.B1) {
      p.prod_blk[s * p.B1 + r] =
          row_sum(prod, p.bs_idx + r * p.Lbs, p.bs_mask + r * p.Lbs, p.Lbs);
      return;
    }
    r -= p.B1;
    if (r < p.B1) {
      double acc = 0.0;
      for (long long l = 0; l < p.Lb; ++l) {
        const long long j = p.br_idx[r * p.Lb + l];
        const double a = p.alive[s * p.n + p.dix(DI_DST, j)] * p.dfv(DF_DINB, j);
        acc += a * p.br_mask[r * p.Lb + l];
      }
      p.alive_blk[s * p.B1 + r] = acc;
      return;
    }
    r -= p.B1;
  }
  // weakhash group row r: capacity sum and its alive-uniform fallback
  double cap = 0.0, cap_fb = 0.0;
  for (long long l = 0; l < p.Lg; ++l) {
    const long long j = p.gr_idx[r * p.Lg + l];
    const double m = p.gr_mask[r * p.Lg + l];
    const long long t = p.dix(DI_DST, j);
    const double alive_d = p.alive[s * p.n + t];
    const double free_d = p.free_[s * p.n + t];
    const bool wh = p.dfv(DF_M_WH, j) > 0.5;
    cap += (wh ? max_(free_d, 1e-9) * alive_d : 0.0) * m;
    cap_fb += (wh ? alive_d + 1e-9 : 0.0) * m;
  }
  p.capsum[s * p.G1 + r] = cap;
  p.capsum_fb[s * p.G1 + r] = cap_fb;
}

// stage 2: per-edge normaliser rs over the er rows
__global__ void k_edge_norm(Phase p) {
  const long long i = tid();
  if (i >= p.S * p.E) return;
  const long long s = i / p.E, e = i % p.E;
  double acc = 0.0;
  for (long long l = 0; l < p.Le; ++l)
    acc += val_nrm(p, s, p.er_idx[e * p.Le + l]) * p.er_mask[e * p.Le + l];
  p.rs[s * p.E + e] = acc;
}

// stage 3: per dst entry — arriving, dead single-task drops, head-of-line ratio
__global__ void k_entries(Phase p) {
  const long long i = tid();
  if (i >= p.S * p.D) return;
  const long long s = i / p.D, j = i % p.D;
  const long long t = p.dix(DI_DST, j);
  const double alive_d = p.alive[s * p.n + t];
  const double free_d = p.free_[s * p.n + t];
  const long long e = p.dix(DI_EDGE_OF, j);
  const double tot_e = p.tot_slot[s * p.Rs + p.soe[e]];
  double arriving;
  if (p.dfv(DF_M_FWD, j) > 0.5) {
    arriving = p.produced[s * p.n + p.dix(DI_FWD_SRC, j)] * alive_d;
  } else if (p.dfv(DF_M_BLK, j) > 0.5) {
    arriving = 0.0;
    if (p.has_blk) {
      const long long b = p.dix(DI_BLK_OF, j);
      const double ab = p.alive_blk[s * p.B1 + b];
      const double rate = ab > 0.0 ? p.prod_blk[s * p.B1 + b] / ab : 0.0;
      arriving = p.dfv(DF_DINB, j) > 0.0 ? rate * alive_d : 0.0;
    }
  } else if (p.dfv(DF_M_HASH, j) > 0.5) {
    arriving = tot_e * p.dfv(DF_SHARE, j);
  } else {
    const double rs = p.rs[s * p.E + e];
    const double ratio_e = rs > 0.0 ? tot_e / rs : 0.0;
    arriving = val_nrm(p, s, j) * ratio_e;
  }
  const bool dead = alive_d <= 0.0 && p.ms[s * p.n + t] > 0.5;
  p.dropped[s * p.D + j] = dead ? arriving : 0.0;
  if (dead) arriving = 0.0;
  p.arr[s * p.D + j] = arriving;
  p.ratio[s * p.D + j] =
      arriving > 1e-9 ? free_d / max_(arriving, 1e-300) : CUDART_INF;
}

// stage 4: head-of-line row minima over the ratio rows
__global__ void k_row_minima(Phase p) {
  const long long rows = p.E + (p.has_blk ? p.B1 : 0);
  const long long i = tid();
  if (i >= p.S * rows) return;
  const long long s = i / rows, r = i % rows;
  const double* ratio = p.ratio + s * p.D;
  if (r < p.E) {
    p.lam_e[s * p.E + r] =
        min_(row_min(ratio, p.er_idx + r * p.Le, p.er_mask + r * p.Le, p.Le), 1.0);
  } else {
    const long long b = r - p.E;
    p.lam_b[s * p.B1 + b] =
        min_(row_min(ratio, p.br_idx + b * p.Lb, p.br_mask + b * p.Lb, p.Lb), 1.0);
  }
}

// stage 5: per edge row — acceptance of its members and their overflow sum
__global__ void k_accept(Phase p) {
  const long long i = tid();
  if (i >= p.S * p.E) return;
  const long long s = i / p.E, e = i % p.E;
  double ovf = 0.0;
  for (long long l = 0; l < p.Le; ++l) {
    const double m = p.er_mask[e * p.Le + l];
    if (!(m > 0.5)) continue;
    const long long j = p.er_idx[e * p.Le + l];
    const double a = p.arr[s * p.D + j];
    const double free_d = p.free_[s * p.n + p.dix(DI_DST, j)];
    double acc;
    if (p.dfv(DF_M_ACC_S, j) > 0.5) {
      acc = a * p.lam_e[s * p.E + p.dix(DI_EDGE_OF, j)];
    } else if (p.dfv(DF_M_ACC_B, j) > 0.5) {
      acc = p.has_blk ? a * p.lam_b[s * p.B1 + p.dix(DI_BLK_OF, j)] : a;
    } else {
      acc = min_(a, free_d);
    }
    p.accepted[s * p.D + j] = acc;
    ovf += (a - acc) * m;
  }
  p.overflow[s * p.E + e] = ovf;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int tick_phase_launch(void* const* ptrs, const long long* dims,
                                 void* stream) {
  Phase p;
  p.produced = static_cast<const double*>(ptrs[P_PRODUCED]);
  p.alive = static_cast<const double*>(ptrs[P_ALIVE]);
  p.free_ = static_cast<const double*>(ptrs[P_FREE]);
  p.ms = static_cast<const double*>(ptrs[P_MS]);
  p.di = static_cast<const int*>(ptrs[P_DI]);
  p.df = static_cast<const double*>(ptrs[P_DF]);
  p.s_idx = static_cast<const int*>(ptrs[P_S_IDX]);
  p.s_mask = static_cast<const double*>(ptrs[P_S_MASK]);
  p.soe = static_cast<const int*>(ptrs[P_SOE]);
  p.er_idx = static_cast<const int*>(ptrs[P_ER_IDX]);
  p.er_mask = static_cast<const double*>(ptrs[P_ER_MASK]);
  p.gr_idx = static_cast<const int*>(ptrs[P_GR_IDX]);
  p.gr_mask = static_cast<const double*>(ptrs[P_GR_MASK]);
  p.br_idx = static_cast<const int*>(ptrs[P_BR_IDX]);
  p.br_mask = static_cast<const double*>(ptrs[P_BR_MASK]);
  p.bs_idx = static_cast<const int*>(ptrs[P_BS_IDX]);
  p.bs_mask = static_cast<const double*>(ptrs[P_BS_MASK]);
  p.accepted = static_cast<double*>(ptrs[P_ACCEPTED]);
  p.dropped = static_cast<double*>(ptrs[P_DROPPED]);
  p.overflow = static_cast<double*>(ptrs[P_OVERFLOW]);
  p.S = dims[D_S]; p.n = dims[D_NTASKS]; p.D = dims[D_D]; p.E = dims[D_E];
  p.Rs = dims[D_RS]; p.Ls = dims[D_LS]; p.Le = dims[D_LE];
  p.G1 = dims[D_G1]; p.Lg = dims[D_LG];
  p.B1 = dims[D_B1]; p.Lb = dims[D_LB]; p.Lbs = dims[D_LBS];
  p.has_blk = dims[D_HAS_BLK] != 0;
  p.has_grp = dims[D_HAS_GRP] != 0;
  // workspace carve, in kernel.py workspace_size order
  double* w = static_cast<double*>(ptrs[P_WORK]);
  const long long S = p.S;
  p.tot_slot = w;  w += S * p.Rs;
  p.prod_blk = w;  w += S * p.B1;
  p.alive_blk = w; w += S * p.B1;
  p.lam_b = w;     w += S * p.B1;
  p.capsum = w;    w += S * p.G1;
  p.capsum_fb = w; w += S * p.G1;
  p.rs = w;        w += S * p.E;
  p.lam_e = w;     w += S * p.E;
  p.arr = w;       w += S * p.D;
  p.ratio = w;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows1 = p.Rs + (p.has_blk ? 2 * p.B1 : 0)
                          + (p.has_grp ? p.G1 : 0);
  const long long rows4 = p.E + (p.has_blk ? p.B1 : 0);
  k_input_rows<<<blocks_for(S * rows1), kThreads, 0, st>>>(p);
  k_edge_norm<<<blocks_for(S * p.E), kThreads, 0, st>>>(p);
  k_entries<<<blocks_for(S * p.D), kThreads, 0, st>>>(p);
  k_row_minima<<<blocks_for(S * rows4), kThreads, 0, st>>>(p);
  k_accept<<<blocks_for(S * p.E), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
