// The constrained tick's window solve on the host: admm_box_solve_group
// (csrc/admm_group.cuh) with each instance's 16 lanes as threads, against the
// one-thread admm_box_solve (csrc/admm.cuh), on window systems that
// tests/test_torch_box_group.py writes from the plain path. Each case runs in
// float64 and float32 in the layout that the state size takes on the card
// (box_u_shared). x, the z/y ring and the iteration counts must agree bit for
// bit; built without FMA contraction, so both sides round every operation
// alike.
//
//   g++ -std=c++20 -O1 -ffp-contract=off -pthread -I<csrc> harness.cpp -o harness
//   ./harness case.bin ...   (exit 0: every case bit for bit)
#include "prelude.h"
#include "admm_group.cuh"
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
namespace dem { alignas(16) unsigned char dem_box_smem[1 << 21]; }
using namespace dem;

// a case file: N, s, B, zbase; the settings' 5 ints and 7 reals; D, U, r,
// lb, ub and the warm-start ring z0, y0, all float64 in the lanes layout
struct Case { int N, s, B, zbase; std::vector<double> D, U, r, lb, ub, z0, y0; int ints[5]; double reals[7]; };

static Case read_case(const char* path) {
  Case c; FILE* f = fopen(path, "rb"); if (!f) { perror(path); exit(2); }
  int h[4];
  bool ok = fread(h, sizeof(int), 4, f) == 4;
  c.N = h[0]; c.s = h[1]; c.B = h[2]; c.zbase = h[3];
  ok = ok && fread(c.ints, sizeof(int), 5, f) == 5 && fread(c.reals, sizeof(double), 7, f) == 7;
  auto rd = [&](std::vector<double>& v, size_t n) {
    v.resize(n); ok = ok && fread(v.data(), sizeof(double), n, f) == n; };
  size_t N = c.N, s = c.s, B = c.B;
  rd(c.D, N * s * s * B); rd(c.U, (N - 1) * s * s * B); rd(c.r, N * s * B);
  rd(c.lb, s * B); rd(c.ub, s * B); rd(c.z0, N * s * B); rd(c.y0, N * s * B);
  fclose(f);
  if (!ok) { fprintf(stderr, "%s: short file\n", path); exit(2); }
  return c;
}

template <typename T> static std::vector<T> cv(const std::vector<double>& v) { return std::vector<T>(v.begin(), v.end()); }

template <typename T, int S>
static int run(const Case& c, const char* tag) {
  constexpr bool USH = box_u_shared<S>();
  const int N = c.N, B = c.B;
  auto D = cv<T>(c.D), U = cv<T>(c.U), r = cv<T>(c.r), lb = cv<T>(c.lb), ub = cv<T>(c.ub);
  AdmmSettings<T> a = admm_settings<T>(c.ints, c.reals);
  // one thread per instance
  auto z1 = cv<T>(c.z0), y1 = cv<T>(c.y0);
  std::vector<T> x1(N * S * B), Sinv(N * S * S * B), ys(N * S * B);
  std::vector<int> it1(B), it2(B);
  AdmmPtrs<T> w; w.D = D.data(); w.U = U.data(); w.r = r.data(); w.x = x1.data();
  w.z = z1.data(); w.y = y1.data(); w.Sinv = Sinv.data(); w.ys = ys.data();
  for (int b = 0; b < B; ++b) {
    T lo[S], hi[S];
    load<S>(lo, lb.data(), 0, B, b); load<S>(hi, ub.data(), 0, B, b);
    it1[b] = admm_box_solve<T, S>(w, a, lo, hi, c.zbase, N, B, b);
  }
  // the group, one instance at a time
  auto z2 = cv<T>(c.z0), y2 = cv<T>(c.y0);
  std::vector<T> x2(N * S * B);
  std::barrier<> bar(BOX_G); g_bar = &bar;
  for (int b = 0; b < B; ++b) {
    std::vector<std::thread> th;
    for (int l = 0; l < BOX_G; ++l)
      th.emplace_back([&, l] {
        threadIdx.x = l;
        BoxGroup<T> g = box_group<T, S, USH>(N, B, b);
        T lbi = 0, ubi = 0;
        if (g.ln < S) { lbi = ld(lb.data(), g.ln, B, b); ubi = ld(ub.data(), g.ln, B, b); }
        int its = admm_box_solve_group<T, S, USH>(g, D.data(), U.data(), r.data(), z2.data(),
                                                  y2.data(), a, lbi, ubi, c.zbase);
        if (l == 0) it2[b] = its;
        if (g.ln < S)
          for (int j = 0; j < N; ++j)
            st(x2.data(), (size_t)j * S + g.ln, B, b, g.sm[BoxLayout<T, S, USH>::x(N) + j * S + g.ln]);
        __syncwarp(g.mask);
      });
    for (auto& t : th) t.join();
  }
  int bad = 0;
  auto cmp = [&](const char* f, const std::vector<T>& p, const std::vector<T>& q) {
    int n = 0;
    for (size_t k = 0; k < p.size(); ++k) {
      if (memcmp(&p[k], &q[k], sizeof(T)) != 0 && !(std::isnan(p[k]) && std::isnan(q[k]))) {
        if (n < 3) printf("  %s[%zu]: %.17g vs %.17g\n", f, k, (double)p[k], (double)q[k]);
        ++n;
      }
    }
    bad += n; return n;
  };
  int nx = cmp("x", x1, x2), nz = cmp("z", z1, z2), ny = cmp("y", y1, y2);
  int ni = 0; for (int b = 0; b < B; ++b) ni += it1[b] != it2[b];
  double xmax = 0;
  for (auto v : x1) xmax = std::fmax(xmax, std::fabs((double)v));
  printf("%s %s s=%d USH=%d: x %d z %d y %d iters %d differ; iters[0]=%d, max|x|=%g\n", tag,
         sizeof(T) == 8 ? "f64" : "f32", S, (int)USH, nx, nz, ny, ni, it1[0], xmax);
  return bad + ni;
}

int main(int argc, char** argv) {
  int fails = 0;
  for (int i = 1; i < argc; ++i) {
    Case c = read_case(argv[i]);
    if (c.s == 9) fails += run<double, 9>(c, argv[i]) + run<float, 9>(c, argv[i]);
    else if (c.s == 15) fails += run<double, 15>(c, argv[i]) + run<float, 15>(c, argv[i]);
    else { fprintf(stderr, "%s: s=%d\n", argv[i], c.s); return 2; }
  }
  printf(fails ? "FAIL\n" : "ALL BIT-IDENTICAL\n");
  return fails != 0;
}
