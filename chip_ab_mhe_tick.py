#!/usr/bin/env python3
"""Time the unconstrained ``mhe_tick`` kernel of two checkouts in turns on one card.

    python3 chip_ab_mhe_tick.py OTHER_CHECKOUT

Run from the root of this checkout on a machine with one NVIDIA GPU and nvcc.
``OTHER_CHECKOUT`` is the root of a second checkout (for instance the parent
commit unpacked with ``git archive`` into a git-ignored directory). Two
versions are only comparable within one run on one card, so the order is
other, this, this, other; each turn is a fresh process that builds that
checkout's kernels at first use (cached for its second turn), draws the
headline fleet (T=2000, B=1024, float32, seed 0) and prints best-of-3 device
times of ``mhe_replay_kernel.replay_ticks`` over ticks 1..T-1, three times.
"""

import json
import subprocess
import sys

# run with a checkout's root as working directory: ``python -c`` puts it first
# on the module path, so each turn imports that checkout's chip_smoke and package
TURN = r'''
import json
import chip_smoke as cs
from decentralized_ekf_mhe_tpu_torch.config import EKFParams
from decentralized_ekf_mhe_tpu_torch.kernels import ekf_kernel
from decentralized_ekf_mhe_tpu_torch.kernels import mhe_replay_kernel as mrk
from decentralized_ekf_mhe_tpu_torch.ops import ekf_lanes
_, *fleet64 = cs.make_fleet(cs.T_MAIN, cs.B_MAIN, cs.F64, seed=0)
fleet32 = tuple(cs.cast(nt, cs.F32) for nt in fleet64)
del fleet64
pe = EKFParams()
ec = ekf_lanes.make_consts(pe, cs.F32)
st = ekf_lanes.init_state(pe, cs.B_MAIN, cs.RING, cs.F32, device=cs.DEV)
q, _ = ekf_kernel.replay(ec, st, fleet32[1], device=cs.DEV)
c, _, ks, (d, v, i) = cs.stage_inputs(cs.go1_params(), fleet32, q, cs.F32)
ms = [cs.timed(lambda: mrk.replay_ticks(c, ks, d, v, i, device=cs.DEV), reps=3)
      for _ in range(3)]
print(json.dumps({"mhe_tick_ms_best_of_3": ms}))
'''


def main(other):
    for tree in (other, ".", ".", other):
        r = subprocess.run([sys.executable, "-c", TURN], cwd=tree,
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"{tree}: {r.stderr[-2000:]}")
        print(json.dumps({"checkout": tree, **json.loads(r.stdout.strip().splitlines()[-1])}),
              flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
