"""When each keyframe's seeds are installed and its local BA result is
written back, in the JAX package and in the port, both pipelined at depth
12 on the CPU on identical frames: the golden 320x240 plane sequence of
tests/test_pipeline.py extended to --frames frames, `fast_config()` with
pipelined=True, pipeline_depth=12 (bench.py's depth). The port gets JAX's
bootstrap RANSAC draws.

    python tests/install_latency_d12.py --frames 48

For each package it records, per keyframe (by its frame id), the add_image
call (0-based; "flush" for flush()) in which the keyframe's deferred seed
detection was installed and in which its local BA result was written
back. It prints both lists and where they differ, and a JSON summary as
the last line. Not collected by pytest: a run takes a few minutes of CPU.
"""
import argparse
import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from plsvo_torch import convert  # noqa: E402
from plsvo_torch.camera import PinholeCamera as TCam  # noqa: E402
from plsvo_torch.parallel import ba as tba  # noqa: E402
from plsvo_torch.pipeline import frame_handler as tfh  # noqa: E402
from plsvo_tpu.camera import PinholeCamera  # noqa: E402
from plsvo_tpu.config import fast_config  # noqa: E402
from plsvo_tpu.parallel import ba as jba  # noqa: E402
from plsvo_tpu.pipeline import frame_handler as jfh  # noqa: E402
from plsvo_tpu.utils import synthetic  # noqa: E402

CAM = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)


def jax_ransac_draws(n_valid, n_hyp):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(0), (n_hyp, 4),
                                         0, n_valid))


def frames(n):
    """The golden sequence's trajectory (tests/test_pipeline.py), n frames."""
    scene = synthetic.make_scene(np.random.default_rng(7), size=1024,
                                 texel_size=0.004)
    out = []
    for i in range(n):
        ang = 0.003 * i
        R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.asarray([0.022 * i, 0.006 * np.sin(0.3 * i), -2.0], np.float32)
        out.append(np.asarray(synthetic.render_aa(scene, CAM, jnp.asarray(R),
                                                  jnp.asarray(t))[0]))
    return out


def record(vo, ba_mod):
    """Instrument a handler: {kf frame: call of its seed install}, {kf
    frame: call of its BA write-back}; `drive` sets `call`."""
    call = ["setup"]
    installs, write_backs, kf_now, meta_kf = {}, {}, [None], {}
    make_kf, seed_init = vo._make_keyframe, vo._complete_seed_init
    from_window, write_back = ba_mod.problem_from_window, ba_mod.write_back_window

    def make_keyframe(frame, *a):
        kf_now[0] = int(frame.frame_id)
        try:
            return make_kf(frame, *a)
        finally:
            kf_now[0] = None

    def complete_seed_init(kf_slot, *a):
        kf = int(vo.map.kf_frame_id[kf_slot])
        if vo.stage == jfh.STAGE_DEFAULT:  # the bootstrap's is in SECOND
            installs.setdefault(kf, call[0])
        return seed_init(kf_slot, *a)

    def problem_from_window(*a, **k):
        prob, meta = from_window(*a, **k)
        meta_kf[id(meta)] = kf_now[0]
        return prob, meta

    def write_back_window(m, kf_R, kf_t, lm_pos, meta):
        if m is vo.map:
            write_backs.setdefault(meta_kf.get(id(meta)), call[0])
        return write_back(m, kf_R, kf_t, lm_pos, meta)

    vo._make_keyframe = make_keyframe
    vo._complete_seed_init = complete_seed_init
    ba_mod.problem_from_window = problem_from_window
    ba_mod.write_back_window = write_back_window

    def undo():
        ba_mod.problem_from_window = from_window
        ba_mod.write_back_window = write_back
    return call, installs, write_backs, undo


def drive(vo, ba_mod, imgs):
    call, installs, write_backs, undo = record(vo, ba_mod)
    keyframes = []
    try:
        for i, img in enumerate(imgs):
            call[0] = i
            r = vo.add_image(img, i / 30.0)
            if r is not None and r.is_keyframe:
                keyframes.append(r.frame_id)
        call[0] = "flush"
        keyframes += [r.frame_id for r in vo.flush() if r.is_keyframe]
    finally:
        undo()
    return sorted(keyframes), installs, write_backs


def table(keyframes, installs, write_backs):
    return [(kf, installs.get(kf), write_backs.get(kf)) for kf in keyframes]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    args = ap.parse_args()
    imgs = frames(args.frames)
    cfg = fast_config()
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, pipelined=True, pipeline_depth=12))
    j = table(*drive(jfh.FrameHandlerMono(CAM, cfg), jba, imgs))
    tvo = tfh.FrameHandlerMono(
        TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0),
        convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu",
        ransac_draws=jax_ransac_draws)
    t = table(*drive(tvo, tba, imgs))
    print("keyframe: seed install call, BA write-back call")
    print("JAX: ", j)
    print("port:", t)
    differ = sorted(set(j) ^ set(t))
    print("differ:", differ)
    print(json.dumps({"frames": args.frames, "jax": j, "port": t,
                      "differ": differ}))


if __name__ == "__main__":
    main()
