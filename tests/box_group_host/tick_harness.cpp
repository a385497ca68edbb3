// The unconstrained MHE tick on the host: mhe_body (csrc/mhe_body.cuh) on a
// group of group_size<S>() lanes per instance (GRP; each instance's 16 lanes,
// or 32 from s=16, as std::threads, prelude.h's barrier for __syncwarp)
// against the one-thread body, at the shape the case names — Go1 (9, 12, 4,
// 0), PogoX (9, 3, 1, 0), Cassie (15, 6, 2, 1: foot positions as states) or
// Go1 with its foot positions as states (21, 12, 4, 1) — with the Gauss-Jordan
// or the Cholesky tail (CHOL), on window states and tick inputs that
// tests/test_torch_tick_group.py writes from the plain path. Each case runs in
// float64 and float32; x, the 18 window-state tensors and the Bezier schedule
// must agree bit for bit. A case that names a stage of the ablation (ABL,
// 1..5 with the Gauss-Jordan tail, 1..3 with the Cholesky one, either clock,
// Go1's shape) runs the group's ablated body alone, in float64, for the test
// to hold against the plain version. Built without FMA contraction, so both
// bodies round every operation alike.
//
//   g++ -std=c++20 -O1 -ffp-contract=off -pthread -I<csrc> tick_harness.cpp -o tick_harness
//   ./tick_harness case.bin out.bin ...   (exit 0: every case bit for bit)
// With -DDEM_HARNESS_S=<s> only the shapes of that state size are built (a
// quicker compile for a test of one size).
//
// out.bin: the group's float64 x (Tn,s,B), then its 18 state tensors and
// Bezier times, for the test to hold against the plain version.
#include "prelude.h"
#include "mhe_body.cuh"
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
namespace dem { alignas(16) unsigned char dem_box_smem[1 << 20]; }
using namespace dem;

constexpr int NIN = 8;      // R, accel, omega, pfoot, Jfoot, dq, contact, vo_inc
constexpr int NST = 18;     // the window state (mhe_replay_kernel.state_shapes)

// the sizes of one model shape: per tick and instance the inputs', per
// instance the state's, and the packed consts (mhe_replay_kernel._pack_consts:
// Q_foot_slide last, which mhe_consts reads for LOT == 1)
template <int S, int M, int L, int LOT>
struct Shape {
  static constexpr int NCONST = 1 + M * S + 3 * S + 8 * 9 + 3 + 9;
  static int in_size(int k) {
    const int sz[NIN] = {9, 3, 3, L * 3, L * 9, L * 3, L, 3};
    return sz[k];
  }
  static int st_size(int k, int N) {
    const int sz[NST] = {N * M, N * M * M, N * S * S, N * S, N * S * S, N * 3, N * 9, N,
                         S * S, S, 12, 3, 9, 3, L, N * S * S, N * S * S, N * S};
    return sz[k];
  }
};

// a case file: N, B, Tn, t0, pi, chol, abl, S, M, L, LOT; the consts; the VO
// metadata (Tn or Tn*B each) and the Bezier count (1 or B) as ints; the Bezier
// times (4 or 4B), the inputs and the state as float64, in the lanes layout
struct Case {
  int N, B, Tn, t0, pi, chol, abl, S, M, L, LOT;
  std::vector<double> consts, times, in[NIN], st[NST];
  std::vector<int> active, pre, now, count;
};

static FILE* open_case(const char* path, Case& c) {
  FILE* f = fopen(path, "rb");
  if (!f) { perror(path); exit(2); }
  int h[11];
  if (fread(h, sizeof(int), 11, f) != 11) { fprintf(stderr, "%s: short file\n", path); exit(2); }
  c.N = h[0]; c.B = h[1]; c.Tn = h[2]; c.t0 = h[3]; c.pi = h[4]; c.chol = h[5]; c.abl = h[6];
  c.S = h[7]; c.M = h[8]; c.L = h[9]; c.LOT = h[10];
  return f;
}

template <typename Sh>
static void read_body(FILE* f, const char* path, Case& c) {
  bool ok = true;
  auto rd = [&](auto& v, size_t n) {
    v.resize(n);
    ok = ok && fread(v.data(), sizeof(v[0]), n, f) == n;
  };
  const size_t nb = c.pi ? c.B : 1, Tn = c.Tn, B = c.B;
  rd(c.consts, Sh::NCONST);
  rd(c.active, Tn * nb); rd(c.pre, Tn * nb); rd(c.now, Tn * nb); rd(c.count, nb);
  rd(c.times, 4 * nb);
  for (int k = 0; k < NIN; ++k) rd(c.in[k], Tn * Sh::in_size(k) * B);
  for (int k = 0; k < NST; ++k) rd(c.st[k], (size_t)Sh::st_size(k, c.N) * B);
  fclose(f);
  if (!ok) { fprintf(stderr, "%s: short file\n", path); exit(2); }
}

template <typename T> static std::vector<T> cv(const std::vector<double>& v) {
  return std::vector<T>(v.begin(), v.end());
}

// what one body leaves: x, the state, the Bezier schedule
template <typename T> struct Out {
  std::vector<T> x, st[NST], times;
  std::vector<int> count;
};

template <typename T, int S, int M, int L, int LOT, bool PI, bool CHOL, bool GRP, int ABL>
static Out<T> run(const Case& cs) {
  const int N = cs.N, B = cs.B, Tn = cs.Tn, nb = PI ? B : 1;
  Out<T> o;
  std::vector<T> in[NIN], times_in = cv<T>(cs.times);
  for (int k = 0; k < NIN; ++k) in[k] = cv<T>(cs.in[k]);
  for (int k = 0; k < NST; ++k) o.st[k] = cv<T>(cs.st[k]);
  o.x.assign((size_t)Tn * S * B, T(0));
  o.times.assign(4 * nb, T(0));
  o.count.assign(nb, 0);
  // MhePtrs in declaration order, as the C entry point hands them over
  void* ptrs[34] = {(void*)cs.active.data(), (void*)cs.pre.data(), (void*)cs.now.data(),
                    times_in.data(), (void*)cs.count.data()};
  for (int k = 0; k < NIN; ++k) ptrs[5 + k] = in[k].data();
  for (int k = 0; k < NST; ++k) ptrs[5 + NIN + k] = o.st[k].data();
  ptrs[31] = o.x.data(); ptrs[32] = o.times.data(); ptrs[33] = o.count.data();
  const MhePtrs<T> p = mhe_ptrs<T>(ptrs);
  const MheConstsFor<T, S, M, LOT> c = mhe_consts<T, S, M, LOT>(cs.consts.data());
  if constexpr (!GRP) {
    threadIdx.x = 0;
    for (int b = 0; b < B; ++b)
      mhe_body<T, S, M, L, LOT, false, PI, CHOL>(p, c, nullptr, N, B, Tn, cs.t0, b);
  } else {
    constexpr int G = group_size<S>();
    std::barrier<> bar(G);
    g_bar = &bar;
    for (int b = 0; b < B; ++b) {   // one instance at a time: its shared memory is slot 0
      std::vector<std::thread> th;
      for (int l = 0; l < G; ++l)
        th.emplace_back([&, l] {
          threadIdx.x = l;
          mhe_body<T, S, M, L, LOT, false, PI, CHOL, ABL, true>(p, c, nullptr, N, B, Tn, cs.t0,
                                                               b);
        });
      for (auto& t : th) t.join();
    }
  }
  return o;
}

template <typename T>
static int cmp(const char* f, const std::vector<T>& a, const std::vector<T>& b) {
  int n = 0;
  for (size_t k = 0; k < a.size(); ++k)
    if (memcmp(&a[k], &b[k], sizeof(T)) != 0 && !(std::isnan((double)a[k]) && std::isnan((double)b[k]))) {
      if (n < 3) printf("  %s[%zu]: %.17g vs %.17g\n", f, k, (double)a[k], (double)b[k]);
      ++n;
    }
  return n;
}

template <typename T>
static void write_out(FILE* out, const Out<T>& o) {
  fwrite(o.x.data(), sizeof(T), o.x.size(), out);
  for (int k = 0; k < NST; ++k) fwrite(o.st[k].data(), sizeof(T), o.st[k].size(), out);
  fwrite(o.times.data(), sizeof(T), o.times.size(), out);
}

template <typename T, int S, int M, int L, int LOT, bool PI, bool CHOL>
static int check(const Case& cs, const char* tag, FILE* out) {
  const Out<T> one = run<T, S, M, L, LOT, PI, CHOL, false, ABL_NONE>(cs),
               grp = run<T, S, M, L, LOT, PI, CHOL, true, ABL_NONE>(cs);
  int nx = cmp("x", one.x, grp.x), ns = 0, nb = cmp("bez_times", one.times, grp.times);
  for (int k = 0; k < NST; ++k) {
    char name[16];
    snprintf(name, sizeof name, "state%d", k);
    ns += cmp(name, one.st[k], grp.st[k]);
  }
  for (size_t k = 0; k < one.count.size(); ++k) nb += one.count[k] != grp.count[k];
  double xmax = 0;
  for (auto v : one.x) xmax = std::fmax(xmax, std::fabs((double)v));
  printf("%s s=%d m=%d G=%d %s %s %s: x %d state %d schedule %d differ; max|x|=%g\n", tag, S,
         M, group_size<S>(), sizeof(T) == 8 ? "f64" : "f32", PI ? "per-lane" : "shared",
         CHOL ? "chol" : "gj", nx, ns, nb, xmax);
  if (out) write_out(out, grp);
  return nx + ns + nb;
}

// both types of a case, on its clock with its tail
template <int S, int M, int L, int LOT, bool PI, bool CHOL>
static int both(const Case& cs, const char* tag, FILE* out) {
  return check<double, S, M, L, LOT, PI, CHOL>(cs, tag, out) +
         check<float, S, M, L, LOT, PI, CHOL>(cs, tag, nullptr);
}

// the group's float64 tick with stage ABL skipped, on its clock with its tail
template <int S, int M, int L, int LOT, bool PI, bool CHOL, int ABL>
static int ablated(const Case& cs, const char* tag, FILE* out) {
  write_out(out, run<double, S, M, L, LOT, PI, CHOL, true, ABL>(cs));
  printf("%s s=%d m=%d f64 %s %s ablation %d: written\n", tag, S, M,
         PI ? "per-lane" : "shared", CHOL ? "chol" : "gj", ABL);
  return 0;
}

// the ablated units of one clock and tail (the Cholesky tick's: the stages
// before the tail)
template <int S, int M, int L, int LOT, bool PI, bool CHOL>
static int ablated_stage(const Case& cs, const char* tag, FILE* out) {
  switch (cs.abl) {
    case ABL_INGEST: return ablated<S, M, L, LOT, PI, CHOL, ABL_INGEST>(cs, tag, out);
    case ABL_MARG: return ablated<S, M, L, LOT, PI, CHOL, ABL_MARG>(cs, tag, out);
    case ABL_BUILD: return ablated<S, M, L, LOT, PI, CHOL, ABL_BUILD>(cs, tag, out);
  }
  if constexpr (!CHOL) {
    switch (cs.abl) {
      case ABL_ASSEMBLY: return ablated<S, M, L, LOT, PI, CHOL, ABL_ASSEMBLY>(cs, tag, out);
      case ABL_SOLVE: return ablated<S, M, L, LOT, PI, CHOL, ABL_SOLVE>(cs, tag, out);
    }
  }
  fprintf(stderr, "%s: no ablated unit %d with the %s tail\n", tag, cs.abl, CHOL ? "chol" : "gj");
  exit(2);
}

template <int S, int M, int L, int LOT>
static int run_case(const char* path, FILE* f, Case& cs, FILE* out) {
  read_body<Shape<S, M, L, LOT>>(f, path, cs);
  if (cs.abl) {
    if constexpr (S == 9 && M == 12) {   // Go1's units
      if (cs.chol)
        return cs.pi ? ablated_stage<S, M, L, LOT, true, true>(cs, path, out)
                     : ablated_stage<S, M, L, LOT, false, true>(cs, path, out);
      return cs.pi ? ablated_stage<S, M, L, LOT, true, false>(cs, path, out)
                   : ablated_stage<S, M, L, LOT, false, false>(cs, path, out);
    }
    fprintf(stderr, "%s: no ablated unit %d at s=%d m=%d\n", path, cs.abl, S, M);
    exit(2);
  }
  if (cs.chol)
    return cs.pi ? both<S, M, L, LOT, true, true>(cs, path, out)
                 : both<S, M, L, LOT, false, true>(cs, path, out);
  return cs.pi ? both<S, M, L, LOT, true, false>(cs, path, out)
               : both<S, M, L, LOT, false, false>(cs, path, out);
}

int main(int argc, char** argv) {
  if (argc < 3 || argc % 2 == 0) {
    fprintf(stderr, "usage: %s case.bin out.bin [case.bin out.bin ...]\n", argv[0]);
    return 2;
  }
  int fails = 0;
  for (int a = 1; a < argc; a += 2) {
    Case cs;
    FILE* f = open_case(argv[a], cs);
    FILE* out = fopen(argv[a + 1], "wb");
    if (!out) { perror(argv[a + 1]); return 2; }
    const int shape[4] = {cs.S, cs.M, cs.L, cs.LOT};
    auto is = [&](int s, int m, int l, int lot) {
      return shape[0] == s && shape[1] == m && shape[2] == l && shape[3] == lot;
    };
    if (false) {
#if !defined(DEM_HARNESS_S) || DEM_HARNESS_S == 9
    } else if (is(9, 12, 4, 0)) { fails += run_case<9, 12, 4, 0>(argv[a], f, cs, out);
    } else if (is(9, 3, 1, 0)) { fails += run_case<9, 3, 1, 0>(argv[a], f, cs, out);
#endif
#if !defined(DEM_HARNESS_S) || DEM_HARNESS_S == 15
    } else if (is(15, 6, 2, 1)) { fails += run_case<15, 6, 2, 1>(argv[a], f, cs, out);
#endif
#if !defined(DEM_HARNESS_S) || DEM_HARNESS_S == 21
    } else if (is(21, 12, 4, 1)) { fails += run_case<21, 12, 4, 1>(argv[a], f, cs, out);
#endif
    } else {
      fprintf(stderr, "%s: no instantiation for this shape\n", argv[a]);
      return 2;
    }
    fclose(out);
  }
  printf(fails ? "FAIL\n" : "ALL BIT-IDENTICAL\n");
  return fails != 0;
}
