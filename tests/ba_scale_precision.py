"""BA precision at map scale, both packages, on the CPU (not collected).

tests/test_ba_scale.py's problem (K=96, L=50176, O=6) for a few seeds:
the JAX package's f32 solve, the port's solve in f32 (F64_SLOTS raised
above the problem) and in f64 (the port's default at this size), each
3 iterations, with that test's quality bars; and the first assembly's
gradient b in f32 (both packages) against the port's f64 assembly.

    python tests/ba_scale_precision.py --seeds 0 1 2     # ~1 min a seed
"""
import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from plsvo_torch.parallel import ba as tba  # noqa: E402
from plsvo_tpu.parallel import ba as jba  # noqa: E402
from test_ba_scale import make_big_problem  # noqa: E402


def bars(name, chi2, chi_init, kf_t, lm_pos, tk, pos, err0):
    perr = np.linalg.norm(np.asarray(kf_t, np.float64) - tk, axis=-1)
    err = np.median(np.linalg.norm(np.asarray(lm_pos, np.float64) - pos,
                                   axis=-1))
    ok = (chi2 <= 0.3 * chi_init and perr.max() < 0.06
          and np.median(perr) < 0.01 and err < 1.25 * err0)
    print(f"  {name}: chi2 {chi2:.4e}, pose err max {perr.max():.4f} median "
          f"{np.median(perr):.4f}, landmark median {err:.4f} (initial "
          f"{err0:.4f}): {'meets' if ok else 'misses'} test_ba_scale's bars",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    for seed in args.seeds:
        prob, (Rk, tk, pos) = make_big_problem(np.random.default_rng(seed))
        npp = tba.BAProblem(*[None if a is None else np.asarray(a)
                              for a in prob])
        tp = tba.problem_to(npp, "cpu")
        err0 = float(np.median(np.linalg.norm(npp.lm_pos - pos, axis=-1)))
        chi_init = float(jba.bundle_adjust(prob, n_iter=0)[1].chi2)
        print(f"seed {seed}: {npp.obs_valid.size} observation slots, initial "
              f"chi2 {chi_init:.4e}", flush=True)
        b64 = tba._assemble_shard(tba._cast(tp, torch.float64), 1 / 250.0,
                                  1e-8)[1].numpy()
        b32 = tba._assemble_shard(tp, 1 / 250.0, 1e-8)[1].numpy()
        bj = np.asarray(jba._assemble_shard(prob, 1 / 250.0, 1e-8)[1])
        print(f"  gradient b: max |b| {np.abs(b64).max():.3e} (f64); f32 "
              f"error JAX {np.abs(bj - b64).max():.3e}, port "
              f"{np.abs(b32 - b64).max():.3e}", flush=True)
        out, st = jba.bundle_adjust(prob, n_iter=3)
        bars("JAX f32", float(st.chi2), chi_init, out.kf_t, out.lm_pos, tk,
             pos, err0)
        saved = tba.F64_SLOTS
        tba.F64_SLOTS = npp.obs_valid.size
        try:
            out, st = tba.bundle_adjust(tp, n_iter=3)
        finally:
            tba.F64_SLOTS = saved
        bars("port f32", float(st.chi2), chi_init, out.kf_t.numpy(),
             out.lm_pos.numpy(), tk, pos, err0)
        out, st = tba.bundle_adjust(tp, n_iter=3)
        bars("port (f64 above F64_SLOTS)", float(st.chi2), chi_init,
             out.kf_t.numpy(), out.lm_pos.numpy(), tk, pos, err0)


if __name__ == "__main__":
    main()
