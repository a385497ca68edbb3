// The unconstrained MHE tick on the host: mhe_body (csrc/mhe_body.cuh) at
// Cassie's shape (s=15, m=6, L=2, foot positions as states) on a group of
// BOX_G lanes per instance (GRP; each instance's 16 lanes as std::threads,
// prelude.h's barrier for __syncwarp) against the one-thread body, with the
// Gauss-Jordan or the Cholesky tail (CHOL) as the case names it, on window
// states and tick inputs that tests/test_torch_tick_group.py writes from the
// plain path. Each case runs in float64 and float32; x, the 18 window-state
// tensors and the Bezier schedule must agree bit for bit. Built without FMA
// contraction, so both bodies round every operation alike.
//
//   g++ -std=c++20 -O1 -ffp-contract=off -pthread -I<csrc> tick_harness.cpp -o tick_harness
//   ./tick_harness case.bin out.bin ...   (exit 0: every case bit for bit)
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

constexpr int S = 15, M = 6, L = 2, LOT = 1;
constexpr int NCONST = 1 + M * S + 3 * S + 8 * 9 + 3 + 9;   // mhe_consts reads them
constexpr int NIN = 8;      // R, accel, omega, pfoot, Jfoot, dq, contact, vo_inc
constexpr int NST = 18;     // the window state (mhe_replay_kernel.state_shapes)

// per tick and instance: the inputs' sizes; per instance: the state's
static const int IN_SIZE[NIN] = {9, 3, 3, L * 3, L * 9, L * 3, L, 3};
static int st_size(int k, int N) {
  const int sz[NST] = {N * M, N * M * M, N * S * S, N * S, N * S * S, N * 3, N * 9, N,
                       S * S, S, 12, 3, 9, 3, L, N * S * S, N * S * S, N * S};
  return sz[k];
}

// a case file: N, B, Tn, t0, pi, chol; the consts; the VO metadata (Tn or Tn*B
// each) and the Bezier count (1 or B) as ints; the Bezier times (4 or 4B),
// the inputs and the state as float64, in the lanes layout
struct Case {
  int N, B, Tn, t0, pi, chol;
  std::vector<double> consts, times, in[NIN], st[NST];
  std::vector<int> active, pre, now, count;
};

static Case read_case(const char* path) {
  Case c;
  FILE* f = fopen(path, "rb");
  if (!f) { perror(path); exit(2); }
  int h[6];
  bool ok = fread(h, sizeof(int), 6, f) == 6;
  c.N = h[0]; c.B = h[1]; c.Tn = h[2]; c.t0 = h[3]; c.pi = h[4]; c.chol = h[5];
  auto rd = [&](auto& v, size_t n) {
    v.resize(n);
    ok = ok && fread(v.data(), sizeof(v[0]), n, f) == n;
  };
  const size_t nb = c.pi ? c.B : 1, Tn = c.Tn, B = c.B;
  rd(c.consts, NCONST);
  rd(c.active, Tn * nb); rd(c.pre, Tn * nb); rd(c.now, Tn * nb); rd(c.count, nb);
  rd(c.times, 4 * nb);
  for (int k = 0; k < NIN; ++k) rd(c.in[k], Tn * IN_SIZE[k] * B);
  for (int k = 0; k < NST; ++k) rd(c.st[k], (size_t)st_size(k, c.N) * B);
  fclose(f);
  if (!ok) { fprintf(stderr, "%s: short file\n", path); exit(2); }
  return c;
}

template <typename T> static std::vector<T> cv(const std::vector<double>& v) {
  return std::vector<T>(v.begin(), v.end());
}

// what one body leaves: x, the state, the Bezier schedule
template <typename T> struct Out {
  std::vector<T> x, st[NST], times;
  std::vector<int> count;
};

template <typename T, bool PI, bool CHOL, bool GRP>
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
    std::barrier<> bar(BOX_G);
    g_bar = &bar;
    for (int b = 0; b < B; ++b) {   // one instance at a time: its shared memory is slot 0
      std::vector<std::thread> th;
      for (int l = 0; l < BOX_G; ++l)
        th.emplace_back([&, l] {
          threadIdx.x = l;
          mhe_body<T, S, M, L, LOT, false, PI, CHOL, ABL_NONE, true>(p, c, nullptr, N, B, Tn,
                                                                     cs.t0, b);
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

template <typename T, bool PI, bool CHOL>
static int check(const Case& cs, const char* tag, FILE* out) {
  const Out<T> one = run<T, PI, CHOL, false>(cs), grp = run<T, PI, CHOL, true>(cs);
  int nx = cmp("x", one.x, grp.x), ns = 0, nb = cmp("bez_times", one.times, grp.times);
  for (int k = 0; k < NST; ++k) {
    char name[16];
    snprintf(name, sizeof name, "state%d", k);
    ns += cmp(name, one.st[k], grp.st[k]);
  }
  for (size_t k = 0; k < one.count.size(); ++k) nb += one.count[k] != grp.count[k];
  double xmax = 0;
  for (auto v : one.x) xmax = std::fmax(xmax, std::fabs((double)v));
  printf("%s %s %s %s: x %d state %d schedule %d differ; max|x|=%g\n", tag,
         sizeof(T) == 8 ? "f64" : "f32", PI ? "per-lane" : "shared", CHOL ? "chol" : "gj", nx,
         ns, nb, xmax);
  if (out) {
    fwrite(grp.x.data(), sizeof(T), grp.x.size(), out);
    for (int k = 0; k < NST; ++k) fwrite(grp.st[k].data(), sizeof(T), grp.st[k].size(), out);
    fwrite(grp.times.data(), sizeof(T), grp.times.size(), out);
  }
  return nx + ns + nb;
}

// both types of a case, on its clock with its tail
template <bool PI, bool CHOL>
static int both(const Case& cs, const char* tag, FILE* out) {
  return check<double, PI, CHOL>(cs, tag, out) + check<float, PI, CHOL>(cs, tag, nullptr);
}

int main(int argc, char** argv) {
  if (argc < 3 || argc % 2 == 0) {
    fprintf(stderr, "usage: %s case.bin out.bin [case.bin out.bin ...]\n", argv[0]);
    return 2;
  }
  int fails = 0;
  for (int a = 1; a < argc; a += 2) {
    const Case cs = read_case(argv[a]);
    FILE* out = fopen(argv[a + 1], "wb");
    if (!out) { perror(argv[a + 1]); return 2; }
    const char* tag = argv[a];
    fails += cs.pi ? (cs.chol ? both<true, true>(cs, tag, out) : both<true, false>(cs, tag, out))
                   : (cs.chol ? both<false, true>(cs, tag, out) : both<false, false>(cs, tag, out));
    fclose(out);
  }
  printf(fails ? "FAIL\n" : "ALL BIT-IDENTICAL\n");
  return fails != 0;
}
