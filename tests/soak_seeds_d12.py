"""The tail drift of tests/test_soak.py's sequence pipelined at depth 12, in
the JAX package and in the port, from the same bootstrap RANSAC draws:
JAX's homography_init with seed k, and the port with the same draws
(chip_smoke.reference_ransac_draws(seed=k)), on identical frames: the
310-frame 320x240 orbit without the blackout, `fast_config()` with
pipelined=True, pipeline_depth=12 (bench.py's depth).

    python tests/soak_seeds_d12.py --seeds 0 1 2 --package both

For each package and seed it prints the Sim3 ATE of the last 140 frames
(test_soak's statistic; None when 100 or fewer of them are DEFAULT), how
many of them are DEFAULT, and for the port whether the synced carry equals
the mirror after flush(); a JSON summary is the last line. Not collected by
pytest: each run takes 1-4 minutes of CPU.
"""
import argparse
import dataclasses
import functools
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from plsvo_torch import convert  # noqa: E402
from plsvo_torch.camera import PinholeCamera as TCam  # noqa: E402
from plsvo_torch.pipeline import frame_handler as tfh  # noqa: E402
from plsvo_torch.pipeline import fused as tfused  # noqa: E402
from plsvo_tpu.camera import PinholeCamera  # noqa: E402
from plsvo_tpu.config import fast_config  # noqa: E402
from plsvo_tpu.ops import homography  # noqa: E402
from plsvo_tpu.pipeline import frame_handler as jfh  # noqa: E402
from plsvo_tpu.utils import synthetic, trajectory  # noqa: E402
from test_soak import _orbit_pose  # noqa: E402

CAM = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)
N_TAIL = 140


def frames(n):
    scene = synthetic.make_scene(np.random.default_rng(7), size=2048,
                                 texel_size=0.004)
    imgs, centres = [], []
    for i in range(n):
        R, t = _orbit_pose(i)
        imgs.append(np.asarray(synthetic.render_aa(
            scene, CAM, jnp.asarray(R), jnp.asarray(t))[0]))
        centres.append(t)
    return imgs, np.stack(centres)


def drive(vo, imgs):
    out = []
    for i, im in enumerate(imgs):
        r = vo.add_image(im, i / 30.0)
        if r is not None:
            out.append(r)
    return {r.frame_id: r for r in out + vo.flush()}


def tail_ate(by_id, centres):
    n = len(centres)
    idx = [i for i in range(n - N_TAIL, n)
           if i in by_id and by_id[i].stage == jfh.STAGE_DEFAULT]
    if len(idx) <= 100:
        return None, len(idx)
    est = np.stack([-by_id[i].R_f_w.T @ by_id[i].t_f_w for i in idx])
    return float(trajectory.ate_rmse(est.astype(np.float64),
                                     centres[idx].astype(np.float64),
                                     with_scale=True)), len(idx)


def run_jax(cfg, imgs, seed):
    orig = homography.homography_init
    homography.homography_init = functools.partial(orig, seed=seed)
    try:
        return drive(jfh.FrameHandlerMono(CAM, cfg), imgs), None
    finally:
        homography.homography_init = orig


def run_port(cfg, imgs, seed):
    vo = tfh.FrameHandlerMono(
        TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0),
        convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu",
        ransac_draws=functools.partial(chip_smoke.reference_ransac_draws,
                                       seed=seed))
    by_id = drive(vo, imgs)
    bad = tfused.carry_mismatches(vo.sync_carry(),
                                  tfused.map_tables_upload(vo.map))
    return by_id, bad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--package", choices=("both", "jax", "torch"),
                    default="both")
    args = ap.parse_args()
    torch.set_num_threads(2)
    imgs, centres = frames(310)
    cfg = fast_config()
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, pipelined=True, pipeline_depth=12))
    runs = {"jax": run_jax, "torch": run_port}
    pkgs = list(runs) if args.package == "both" else [args.package]
    summary = []
    for seed in args.seeds:
        for pkg in pkgs:
            by_id, bad = runs[pkg](cfg, imgs, seed)
            ate, n_def = tail_ate(by_id, centres)
            row = dict(package=pkg, seed=seed, tail_ate=ate,
                       tail_default=n_def,
                       carry_mismatches=bad)
            print(f"{pkg} seed {seed}: tail ATE {ate} m, {n_def} of the "
                  f"last {N_TAIL} frames DEFAULT"
                  + ("" if bad is None else f", carry vs mirror: {bad or 'equal'}"),
                  flush=True)
            summary.append(row)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
