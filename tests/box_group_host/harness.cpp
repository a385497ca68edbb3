// The group solves on the host, each instance's 16 lanes as threads, against
// their one-thread versions, on systems that the tests write from the plain
// path (tests/test_torch_box_group.py, tests/test_torch_solve_group.py):
//  - the box-ADMM: admm_box_solve_group (csrc/admm_group.cuh) as the
//    constrained tick calls it (warm starts in a ring turned by zbase), or
//    K4's entry admm_solve_group (the kernel of csrc/admm.cu), against the
//    one-thread admm_box_solve (csrc/admm.cuh). x, the z/y ring and the
//    iteration counts must agree bit for bit.
//  - K5: tridiag_solve_group (csrc/tridiag.cuh) on the lanes layout, or on the
//    standard layout read in place through its strides with the warm-up mask
//    applied at load, against the one-thread tridiag_body on the lanes system that
//    ops/tridiag.mask_system and the layout moves give. x must agree bit for
//    bit.
// Each case runs in float64 and float32; built without FMA contraction, so
// both sides round every operation alike.
//
//   g++ -std=c++20 -O1 -ffp-contract=off -pthread -I<csrc> harness.cpp -o harness
//   ./harness case.bin ...   (exit 0: every case bit for bit)
#include "prelude.h"
#include "tridiag.cuh"
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <string>
#include <vector>
namespace dem { alignas(16) unsigned char dem_box_smem[1 << 21]; }
using namespace dem;

// a tick's ADMM case file: N, s, B, zbase; the settings' 5 ints and 7 reals;
// D, U, r, lb, ub and the warm-start ring z0, y0, all float64 in the lanes
// layout. A K4 case file: -2, N, s, B, then as a tick's case (zbase 0, run
// through K4's entry). A K5 case file: -1, N, s, B, standard; the lanes system D, U, r (masked);
// with `standard`, then the thirteen strides (int64) of the standard
// layout's views D (N,B,s,s), U (N-1,B,s,s), r (N,B,s), mask (N,B) of the
// storage that follows: the unmasked D, U, r and the mask as 0/1 values,
// each storage's N s^2 B, (N-1) s^2 B, N s B, N B values.
struct Case {
  int N, s, B, zbase, standard = -1;
  bool k4 = false;
  long long strides[13];
  std::vector<double> D, U, r, lb, ub, z0, y0, Ds, Us, rs, vs;
  int ints[5]; double reals[7];
};

static Case read_case(const char* path) {
  Case c; FILE* f = fopen(path, "rb"); if (!f) { perror(path); exit(2); }
  int h[4];
  bool ok = fread(h, sizeof(int), 4, f) == 4;
  auto rd = [&](std::vector<double>& v, size_t n) {
    v.resize(n); ok = ok && fread(v.data(), sizeof(double), n, f) == n; };
  if (h[0] == -1) {
    c.N = h[1]; c.s = h[2]; c.B = h[3]; c.zbase = 0;
    ok = ok && fread(&c.standard, sizeof(int), 1, f) == 1;
    size_t N = c.N, s = c.s, B = c.B;
    rd(c.D, N * s * s * B); rd(c.U, (N - 1) * s * s * B); rd(c.r, N * s * B);
    if (c.standard) {
      ok = ok && fread(c.strides, sizeof(long long), 13, f) == 13;
      rd(c.Ds, N * s * s * B); rd(c.Us, (N - 1) * s * s * B); rd(c.rs, N * s * B); rd(c.vs, N * B);
    }
  } else {
    c.k4 = h[0] == -2;
    if (c.k4) { c.N = h[1]; c.s = h[2]; c.B = h[3]; c.zbase = 0; }
    else { c.N = h[0]; c.s = h[1]; c.B = h[2]; c.zbase = h[3]; }
    ok = ok && fread(c.ints, sizeof(int), 5, f) == 5 && fread(c.reals, sizeof(double), 7, f) == 7;
    size_t N = c.N, s = c.s, B = c.B;
    rd(c.D, N * s * s * B); rd(c.U, (N - 1) * s * s * B); rd(c.r, N * s * B);
    rd(c.lb, s * B); rd(c.ub, s * B); rd(c.z0, N * s * B); rd(c.y0, N * s * B);
  }
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
        if (c.k4) {   // K4's kernel body
          admm_solve_group<T, S>(D.data(), U.data(), r.data(), lb.data(), ub.data(), x2.data(),
                                 z2.data(), y2.data(), it2.data(), a, N, B, b);
          return;
        }
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
  int ni = 0, imin = it1[0], imax = it1[0];
  for (int b = 0; b < B; ++b) {
    ni += it1[b] != it2[b];
    imin = std::min(imin, it1[b]); imax = std::max(imax, it1[b]);
  }
  double xmax = 0;
  for (auto v : x1) xmax = std::fmax(xmax, std::fabs((double)v));
  std::string counts;
  for (int b = 0; b < B; ++b) counts += (b ? "," : "") + std::to_string(it1[b]);
  printf("%s %s %s s=%d USH=%d: x %d z %d y %d iters %d differ; iters %d..%d [%s], max|x|=%g\n",
         tag, c.k4 ? "k4" : "tick", sizeof(T) == 8 ? "f64" : "f32", S, (int)USH, nx, nz, ny,
         ni, imin, imax, counts.c_str(), xmax);
  return bad + ni;
}

// K5: the group on the case's layout, against tridiag_body on the masked
// lanes system
template <typename T, int S>
static int run_tridiag(const Case& c, const char* tag) {
  const int N = c.N, B = c.B;
  auto D = cv<T>(c.D), U = cv<T>(c.U), r = cv<T>(c.r);
  std::vector<T> x1(N * S * B), Sinv(N * S * S * B), ys(N * S * B), x2(N * S * B);
  for (int b = 0; b < B; ++b) tridiag_body<T, S>(D.data(), U.data(), r.data(), x1.data(),
                                                 Sinv.data(), ys.data(), N, B, b);
  auto Ds = cv<T>(c.Ds), Us = cv<T>(c.Us), rs = cv<T>(c.rs);
  std::vector<char> vs(c.vs.size());   // the mask's bool storage
  for (size_t k = 0; k < vs.size(); ++k) vs[k] = c.vs[k] != 0.0;
  // the (N,B,...) views of the storage, through the case's strides
  TriStrides strides{};
  long long* dst[] = {strides.d, strides.u, strides.r, strides.v};
  const int axes[] = {4, 4, 3, 2};
  for (int a = 0, k = 0; a < 4; ++a)
    for (int i = 0; i < axes[a]; ++i) dst[a][i] = c.strides[k++];
  std::barrier<> bar(BOX_G); g_bar = &bar;
  for (int b = 0; b < B; ++b) {
    std::vector<std::thread> th;
    for (int l = 0; l < BOX_G; ++l)
      th.emplace_back([&, l] {
        threadIdx.x = l;
        if (c.standard)
          tridiag_solve_group<T, S>(
              TriStd<T, S>{Ds.data(), Us.data(), rs.data(), (const bool*)vs.data(), x2.data(),
                           strides, B, b}, N);
        else
          tridiag_solve_group<T, S>(
              TriLanes<T, S>{D.data(), U.data(), r.data(), x2.data(), B, b}, N);
      });
    for (auto& t : th) t.join();
  }
  int n = 0;
  for (int j = 0; j < N; ++j)
    for (int i = 0; i < S; ++i)
      for (int b = 0; b < B; ++b) {
        const T p = x1[((size_t)j * S + i) * B + b];
        const T q = c.standard ? x2[((size_t)j * B + b) * S + i] : x2[((size_t)j * S + i) * B + b];
        if (memcmp(&p, &q, sizeof(T)) != 0 && !(std::isnan(p) && std::isnan(q))) {
          if (n < 3) printf("  x[%d,%d,%d]: %.17g vs %.17g\n", j, i, b, (double)p, (double)q);
          ++n;
        }
      }
  double xmax = 0;
  for (auto v : x1) xmax = std::fmax(xmax, std::fabs((double)v));
  printf("%s k5 %s %s s=%d: x %d differ; max|x|=%g\n", tag,
         c.standard ? "standard" : "lanes", sizeof(T) == 8 ? "f64" : "f32", S, n, xmax);
  return n;
}

template <int S>
static int run_case(const Case& c, const char* tag) {
  if (c.standard < 0) return run<double, S>(c, tag) + run<float, S>(c, tag);
  return run_tridiag<double, S>(c, tag) + run_tridiag<float, S>(c, tag);
}

int main(int argc, char** argv) {
  int fails = 0;
  for (int i = 1; i < argc; ++i) {
    Case c = read_case(argv[i]);
    if (c.s == 9) fails += run_case<9>(c, argv[i]);
    else if (c.s == 15) fails += run_case<15>(c, argv[i]);
    else { fprintf(stderr, "%s: s=%d\n", argv[i], c.s); return 2; }
  }
  printf(fails ? "FAIL\n" : "ALL BIT-IDENTICAL\n");
  return fails != 0;
}
