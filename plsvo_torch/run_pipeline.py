"""Command-line entry point: replay an image-folder dataset through the VO
pipeline, on the card unless --device names another device.

    python -m plsvo_torch.run_pipeline --synthetic DIR [--device cpu]
    python -m plsvo_torch.run_pipeline --dataset DIR --n-frames 14

Port of the JAX package's `run_pipeline.py`, with the same flags and
defaults, plus --device. Per frame it prints the stage, the tracking
quality, the feature counts and the processing time; it writes a TUM
trajectory, prints the Sim3-aligned ATE against the dataset's
groundtruth.txt when there is one, and can write per-frame metrics
(JSONL), annotated frame PNGs and a 3-D map plot. --synthetic renders a
dataset first; --local-ba runs bundle adjustment over the whole map at
every keyframe. Neither PyYAML, Pillow, OpenCV nor matplotlib is needed
except for --mapout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m plsvo_torch.run_pipeline",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", help="dataset dir containing dataset_params.yaml")
    ap.add_argument("--synthetic", metavar="DIR",
                    help="generate a synthetic dataset into DIR and run on it")
    ap.add_argument("--width", type=int, default=752,
                    help="synthetic dataset image width")
    ap.add_argument("--height", type=int, default=480,
                    help="synthetic dataset image height")
    ap.add_argument("--n-frames", type=int, default=60)
    ap.add_argument("--offset", type=int, default=0, help="first frame index")
    ap.add_argument("--step", type=int, default=1, help="frame stride")
    ap.add_argument("--expname", default="experiment")
    ap.add_argument("--config", choices=("default", "fast"), default="default",
                    help="pipeline config preset: 'fast' scales gates and "
                         "capacities for small images (~320x240)")
    ap.add_argument("--no-pt", action="store_true", help="disable point features")
    ap.add_argument("--no-ls", action="store_true", help="disable line features")
    ap.add_argument("--local-ba", action="store_true",
                    help="run bundle adjustment at every keyframe")
    ap.add_argument("--trajout", default=None, help="TUM trajectory output file")
    ap.add_argument("--mapout", default=None, help="3D map plot PNG")
    ap.add_argument("--frames-out", default=None,
                    help="directory for annotated frame PNGs")
    ap.add_argument("--metrics", default=None, help="per-frame metrics JSONL")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    """Run the CLI on argv (None: sys.argv). Returns (handler, dataset, ATE
    in m or None) for callers in the same process."""
    ap = _parser()
    args = ap.parse_args(argv)

    from plsvo_torch.config import Config, fast_config
    from plsvo_torch.device import resolve_device
    from plsvo_torch.parallel import ba
    from plsvo_torch.pipeline.frame_handler import FrameHandlerMono
    from plsvo_torch.utils import dataset as ds
    from plsvo_torch.utils import trajectory, viz

    device = resolve_device(args.device)
    if args.synthetic:
        print(f"generating synthetic dataset in {args.synthetic}...")
        ds.write_synthetic_dataset(args.synthetic, n_frames=args.n_frames,
                                   width=args.width, height=args.height,
                                   device=device)
        args.dataset = args.synthetic
    if not args.dataset:
        ap.error("need --dataset or --synthetic")
    params = os.path.join(args.dataset, "dataset_params.yaml")
    if not os.path.isfile(params):
        ap.error(f"no dataset at {args.dataset!r} ({params} not found)")
    camera, sub = ds.load_dataset_params(params)
    data = ds.ImageFolderDataset(os.path.join(args.dataset, sub), camera,
                                 offset=args.offset, step=args.step,
                                 limit=args.n_frames)
    print(f"{len(data)} frames, camera {camera.width}x{camera.height}")

    base = fast_config() if args.config == "fast" else Config()
    cfg = base.replace(pipeline=dataclasses.replace(
        base.pipeline, has_pt=not args.no_pt, has_ls=not args.no_ls))
    vo = FrameHandlerMono(data.ideal_camera(), cfg, device=device)

    traj, metrics = [], []
    for i, (ts, img) in enumerate(data):
        t0 = time.perf_counter()
        r = vo.add_image(img, ts)
        dt = time.perf_counter() - t0
        print(f"frame {i:4d}  stage={r.stage:12s} q={r.quality:12s} "
              f"pts={r.n_pt_matches:4d} segs={r.n_seg_matches:3d} "
              f"kf={int(r.is_keyframe)}  {dt*1000:7.1f} ms")
        traj.append((ts, r.R_f_w, r.t_f_w))
        metrics.append({
            "frame": i, "stage": r.stage, "quality": r.quality,
            "n_pt": r.n_pt_matches, "n_seg": r.n_seg_matches,
            "keyframe": r.is_keyframe, "proc_ms": dt * 1000,
            **{f"t_{k}_ms": round(v * 1000, 2)
               for k, v in vo.permon.timers.items()}})
        if args.local_ba and r.is_keyframe:
            prob, meta = ba.problem_from_map(vo.map, cfg)
            if prob.lm_pos.shape[0] >= 8:
                out, stats = ba.bundle_adjust(ba.problem_to(prob, device),
                                              n_iter=5)
                ba.write_back_to_map(vo.map, out, meta)
                print(f"        local BA: {int(stats.n_obs)} obs, "
                      f"chi2 {float(stats.chi2):.5f}")
        if args.frames_out:
            os.makedirs(args.frames_out, exist_ok=True)
            last = vo.last_frame
            if last is not None and last.frame_id == r.frame_id:
                ann = viz.draw_tracks(
                    last.pyr[0].cpu().numpy(), last.pt_uv, last.pt_valid,
                    last.seg_suv, last.seg_euv, last.seg_valid)
                viz.save_frame_png(
                    os.path.join(args.frames_out, f"frame_{i:06d}.png"), ann)

    trajout = args.trajout or f"{args.expname}_traj.txt"
    trajectory.write_tum(trajout, traj)
    print(f"trajectory written to {trajout}")

    ate = None
    gt_path = os.path.join(args.dataset, "groundtruth.txt")
    if os.path.exists(gt_path):
        gt = trajectory.read_tum(gt_path)
        est_pos = np.stack([-R.T @ t for _, R, t in traj])
        gt_pos = np.stack([p for _, p, _ in gt])[: len(est_pos)]
        # skip bootstrap frames (identity poses)
        moved = np.linalg.norm(est_pos - est_pos[0], axis=-1) > 1e-9
        if moved.sum() > 5:
            ate = trajectory.ate_rmse(est_pos[moved], gt_pos[moved])
            print(f"ATE RMSE (Sim3-aligned): {ate*100:.2f} cm")
    if args.mapout:
        centers = [-R.T @ t for _, R, t in traj]
        viz.save_map_plot(args.mapout, vo.map, centers)
        print(f"map plot written to {args.mapout}")
    if args.metrics:
        with open(args.metrics, "w") as fh:
            for mrec in metrics:
                fh.write(json.dumps(mrec) + "\n")
    return vo, data, ate


if __name__ == "__main__":
    main()
