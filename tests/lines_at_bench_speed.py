"""Line landmarks and segment matches of the JAX package and the port, both
on the CPU, on identical frames of the bench.py plane sequence (752x480,
fx = fy = 460, `make_scene(default_rng(3), size=2048, texel_size=0.003)`,
ss = 2), with `default_config()` and lines on (has_ls=True, init_ls=True,
pipelined=False; local BA off unless `--ba`). The port gets JAX's bootstrap
RANSAC draws, as in tests/test_torch_pipeline.py, so the two runs can be
compared frame by frame.

    python tests/lines_at_bench_speed.py --frames 40 --step 0.03
    python tests/lines_at_bench_speed.py --frames 28 --step 0.02 --ba \
        --no-pt --n-rects 1680 --n-blobs 160

`--step` is the sideways travel per frame in metres (bench.py: 0.03;
chip_smoke.py's lines run: 0.015, its line-only run: 0.02). `--ba` turns local BA on (the config's
default), `--no-pt` runs line-only mode (has_pt=False), and `--n-rects` /
`--n-blobs` set the scene texture's rectangle and blob counts (the second
command is chip_smoke.py's line-only run). Prints one line per frame for each
package (stage, point matches, segment matches, keyframe, live line seeds,
line landmarks made so far) and a JSON summary as the last line: the first
DEFAULT frame, line landmarks made from converged seeds (and the frame of
the first), the median segment matches over the tracked frames after the
first line landmark (chip_smoke.py's gate) and over all tracked frames,
and the Sim3 ATE. Not collected by pytest: one run takes a few minutes of
CPU at this size.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from plsvo_torch import convert  # noqa: E402
from plsvo_torch.camera import PinholeCamera as TCam  # noqa: E402
from plsvo_torch.pipeline import frame_handler as tfh  # noqa: E402
from plsvo_torch.pipeline import state as tstate  # noqa: E402
from plsvo_tpu.camera import PinholeCamera  # noqa: E402
from plsvo_tpu.config import default_config  # noqa: E402
from plsvo_tpu.pipeline import frame_handler as jfh  # noqa: E402
from plsvo_tpu.pipeline import state as jstate  # noqa: E402
from plsvo_tpu.utils import synthetic, trajectory  # noqa: E402

W, H = 752, 480


def jax_ransac_draws(n_valid, n_hyp):
    """The hypothesis draws of plsvo_tpu.ops.homography.ransac_homography
    (PRNGKey(0), the seed homography_init uses)."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(0), (n_hyp, 4),
                                         0, n_valid))


def frames(n, step, **tex_kw):
    cam = PinholeCamera.create(W, H, 460.0, 460.0, W / 2, H / 2)
    scene = synthetic.make_scene(np.random.default_rng(3), size=2048,
                                 texel_size=0.003, **tex_kw)
    imgs, ts = [], []
    for i in range(n):
        ang = 0.002 * i
        R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.asarray([step * i, 0.008 * np.sin(0.3 * i), -2.0], np.float32)
        img, _ = synthetic.render_aa(scene, cam, jnp.asarray(R),
                                     jnp.asarray(t), ss=2)
        imgs.append(np.asarray(img))
        ts.append(t)
    return cam, imgs, np.stack(ts)


def run(name, vo, map_cls, imgs, gt):
    made = []
    frame = [-1]
    orig = map_cls.new_line

    def counting(self, *a, **k):
        r = orig(self, *a, **k)
        if r >= 0:
            made.append(frame[0])
        return r

    map_cls.new_line = counting
    res = []
    t0 = time.perf_counter()
    try:
        for i, img in enumerate(imgs):
            frame[0] = i
            r = vo.add_image(img, i / 30.0)
            res.append(r)
            print(f"{name} {i}: {r.stage} pt {r.n_pt_matches} seg "
                  f"{r.n_seg_matches} kf {int(r.is_keyframe)} line seeds "
                  f"{int(np.asarray(vo._lnseed_alive).sum())} line landmarks "
                  f"{len(made)} ({time.perf_counter() - t0:.0f} s)", flush=True)
    finally:
        map_cls.new_line = orig
    stages = [r.stage for r in res]
    fd = stages.index(jfh.STAGE_DEFAULT) if jfh.STAGE_DEFAULT in stages else None
    out = dict(first_default=fd, line_landmarks=len(made),
               first_line_landmark=made[0] if made else None)
    if fd is None:
        return out
    seg = [r.n_seg_matches for r in res]
    after = [n for r, n in zip(res, seg)
             if r.stage == jfh.STAGE_DEFAULT and made and r.frame_id > made[0]]
    est = np.stack([-r.R_f_w.T @ r.t_f_w for r in res[fd:]])
    out.update(
        all_default_after=all(s == jfh.STAGE_DEFAULT for s in stages[fd:]),
        seg_median_after_first_line=float(np.median(after)) if after else None,
        seg_median_tracked=float(np.median(seg[fd:])),
        seg_matches=seg,
        ate=float(trajectory.ate_rmse(est.astype(np.float64),
                                      gt[fd:].astype(np.float64))))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--step", type=float, default=0.03)
    ap.add_argument("--ba", action="store_true", help="local BA on")
    ap.add_argument("--no-pt", action="store_true", help="line-only mode")
    ap.add_argument("--n-rects", type=int, default=None)
    ap.add_argument("--n-blobs", type=int, default=None)
    args = ap.parse_args()
    tex_kw = {k: v for k, v in (("n_rects", args.n_rects),
                                ("n_blobs", args.n_blobs)) if v is not None}
    cam, imgs, gt = frames(args.frames, args.step, **tex_kw)
    cfg = default_config()
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, has_ls=True, init_ls=True, loba_enabled=args.ba,
        has_pt=not args.no_pt, pipelined=False))
    j = run("jax", jfh.FrameHandlerMono(cam, cfg), jstate.MapState, imgs, gt)
    tvo = tfh.FrameHandlerMono(
        TCam.create(W, H, 460.0, 460.0, W / 2, H / 2),
        convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu",
        ransac_draws=jax_ransac_draws)
    t = run("port", tvo, tstate.MapState, imgs, gt)
    print(json.dumps(dict(frames=args.frames, step=args.step, ba=args.ba,
                          no_pt=args.no_pt, **tex_kw, jax=j, port=t)),
          flush=True)


if __name__ == "__main__":
    main()
