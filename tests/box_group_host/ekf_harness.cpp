// K1's body on the host: ekf_group_body (csrc/ekf.cuh) with every thread of a
// block as a std::thread (prelude.h: the barrier spans the block, for
// __syncthreads and __syncwarp, __shfl_sync goes through a slot per thread;
// the staged chunks are copied synchronously), one block after another, on
// fleets that tests/test_torch_ekf_group.py writes from numpy. The test holds
// the result against the plain version (kernels/ekf_kernel.replay_plain).
// Built without FMA contraction.
//
//   g++ -std=c++20 -O1 -ffp-contract=off -pthread -I<csrc> ekf_harness.cpp -o ekf_harness
//   ./ekf_harness case.bin out.bin        run one case
//   ./ekf_harness --layout R S pl ipb item CT   print the block's shared bytes
//                                               and instance stride
//
// case.bin: ints Tn, S, R, B, t0, pl (a VO quaternion per lane), quirk_W, ipb
// (instances per block), CT (ticks per staged chunk), is_double;
// the 39 packed consts (kernels/ekf_kernel._pack_consts); gyro, accel, vo_q,
// then the state q, P, gh, ah, qh, Ph, all float64 in the lanes layout; the
// schedule valid, vo_active, vo_sb (Tn*S ints each).
// out.bin: q_seq, then the state carried out q, P, gh, ah, qh, Ph, as float64.
#include "prelude.h"
#include "ekf.cuh"
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
namespace dem { alignas(16) unsigned char dem_ekf_smem[1 << 21]; }
using namespace dem;

struct Case {
  int Tn, S, R, B, t0, pl, quirk_W, ipb, CT, is_double;
  std::vector<double> consts, gyro, accel, vo_q, st[6];
  std::vector<int> valid, act, sb;
};

static void rd(FILE* f, void* v, size_t size, size_t n, const char* path) {
  if (fread(v, size, n, f) != n) { fprintf(stderr, "%s: short file\n", path); exit(2); }
}

template <typename T> static std::vector<T> cv(const std::vector<double>& v) {
  return std::vector<T>(v.begin(), v.end());
}

template <typename T>
static std::vector<double> run(const Case& c) {
  const size_t R = c.R, B = c.B;
  const size_t sizes[6] = {4 * B, 16 * B, 3 * R * B, 3 * R * B, 4 * R * B, 16 * R * B};
  auto gyro = cv<T>(c.gyro), accel = cv<T>(c.accel), vo_q = cv<T>(c.vo_q);
  std::vector<T> in[6], out[6], q_seq((size_t)c.Tn * 4 * B);
  for (int k = 0; k < 6; ++k) { in[k] = cv<T>(c.st[k]); out[k].assign(sizes[k], T(0)); }
  EkfPtrs<T> p;
  p.gyro = gyro.data(); p.accel = accel.data(); p.vo_q = vo_q.data();
  p.valid = c.valid.data(); p.vo_active = c.act.data(); p.vo_sb = c.sb.data();
  p.q_in = in[0].data(); p.P_in = in[1].data(); p.gh_in = in[2].data();
  p.ah_in = in[3].data(); p.qh_in = in[4].data(); p.Ph_in = in[5].data();
  p.q_out = out[0].data(); p.P_out = out[1].data(); p.gh_out = out[2].data();
  p.ah_out = out[3].data(); p.qh_out = out[4].data(); p.Ph_out = out[5].data();
  p.q_seq = q_seq.data();
  EkfConsts<T> k;
  int i = 0;
  k.dt = (T)c.consts[i++];
  for (int e = 0; e < 9; ++e) k.C_gyro[e] = (T)c.consts[i++];
  for (int e = 0; e < 9; ++e) k.C_accel[e] = (T)c.consts[i++];
  for (int e = 0; e < 16; ++e) k.C_vo[e] = (T)c.consts[i++];
  for (int e = 0; e < 3; ++e) k.gravity[e] = (T)c.consts[i++];
  k.g2 = (T)c.consts[i++];
  k.quirk_W = c.quirk_W;
  const EkfDims d = ekf_dims(c.Tn, c.S, c.R, c.B, c.t0, c.pl, c.ipb, (int)sizeof(T), c.CT);
  if (d.bytes((int)sizeof(T)) > sizeof(dem_ekf_smem)) { fprintf(stderr, "block too big\n"); exit(2); }
  const int nthr = EKF_G * c.ipb, grid = (c.B + c.ipb - 1) / c.ipb;
  for (int blk = 0; blk < grid; ++blk) {
    std::barrier<> bar(nthr);
    g_bar = &bar;
    std::vector<std::thread> th;
    for (int tid = 0; tid < nthr; ++tid)
      th.emplace_back([&, tid] {
        threadIdx.x = tid;
        ekf_group_body<T>(p, k, d, blk, tid);
      });
    for (auto& t : th) t.join();
  }
  std::vector<double> res(q_seq.begin(), q_seq.end());
  for (int e = 0; e < 6; ++e) res.insert(res.end(), out[e].begin(), out[e].end());
  return res;
}

int main(int argc, char** argv) {
  if (argc == 8 && !strcmp(argv[1], "--layout")) {
    const int R = atoi(argv[2]), S = atoi(argv[3]), pl = atoi(argv[4]), ipb = atoi(argv[5]),
              item = atoi(argv[6]), CT = atoi(argv[7]);
    const EkfDims d = ekf_dims(0, S, R, 0, 0, pl, ipb, item, CT);
    printf("%zu %d\n", d.bytes(item), d.stride);
    return 0;
  }
  if (argc != 3) { fprintf(stderr, "usage: ekf_harness case.bin out.bin\n"); return 2; }
  FILE* f = fopen(argv[1], "rb");
  if (!f) { perror(argv[1]); return 2; }
  Case c;
  int h[10];
  rd(f, h, sizeof(int), 10, argv[1]);
  c.Tn = h[0]; c.S = h[1]; c.R = h[2]; c.B = h[3]; c.t0 = h[4]; c.pl = h[5];
  c.quirk_W = h[6]; c.ipb = h[7]; c.CT = h[8]; c.is_double = h[9];
  const size_t TS = (size_t)c.Tn * c.S, B = c.B, R = c.R;
  auto rdv = [&](std::vector<double>& v, size_t n) { v.resize(n); rd(f, v.data(), sizeof(double), n, argv[1]); };
  rdv(c.consts, 39);
  rdv(c.gyro, TS * 3 * B);
  rdv(c.accel, TS * 3 * B);
  rdv(c.vo_q, TS * 4 * (c.pl ? B : 1));
  const size_t sizes[6] = {4 * B, 16 * B, 3 * R * B, 3 * R * B, 4 * R * B, 16 * R * B};
  for (int k = 0; k < 6; ++k) rdv(c.st[k], sizes[k]);
  for (auto* v : {&c.valid, &c.act, &c.sb}) { v->resize(TS); rd(f, v->data(), sizeof(int), TS, argv[1]); }
  fclose(f);
  const std::vector<double> res = c.is_double ? run<double>(c) : run<float>(c);
  FILE* o = fopen(argv[2], "wb");
  if (!o || fwrite(res.data(), sizeof(double), res.size(), o) != res.size()) {
    perror(argv[2]);
    return 2;
  }
  fclose(o);
  return 0;
}
