"""The port's command-line entry point end to end, as tests/test_cli_e2e.py
holds the JAX package's: a 40-frame 320x240 image folder of PNGs with a
reference-schema dataset_params.yaml, written by the port; then
`python -m plsvo_torch.run_pipeline --device cpu --config fast` as a
subprocess; a TUM trajectory with bounded ATE and the metrics JSONL out
the other end. The subprocess imports neither JAX nor the JAX package."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from plsvo_torch.utils import dataset as ds
from plsvo_torch.utils import trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_torch")
    data_dir = str(root / "dataset")
    ds.write_synthetic_dataset(data_dir, n_frames=40, width=320, height=240,
                               device="cpu")
    traj_path = str(root / "est_traj.txt")
    metrics_path = str(root / "metrics.jsonl")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    # -X importtime lists every module the process imports (on stderr)
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "plsvo_torch.run_pipeline",
         "--dataset", data_dir, "--n-frames", "40", "--config", "fast",
         "--device", "cpu", "--trajout", traj_path, "--metrics", metrics_path],
        env=env, cwd=str(root), capture_output=True, text=True, timeout=900)
    return data_dir, traj_path, metrics_path, proc


def test_cli_exits_clean_and_writes_trajectory(cli_run):
    data_dir, traj_path, metrics_path, proc = cli_run
    assert proc.returncode == 0, \
        f"CLI failed\nstdout:\n{proc.stdout[-3000:]}\nstderr:\n{proc.stderr[-3000:]}"
    assert os.path.exists(traj_path) and os.path.exists(metrics_path)
    assert "ATE RMSE" in proc.stdout
    imported = re.findall(r"import time:.*\|\s*(\S+)$", proc.stderr, re.M)
    assert "plsvo_torch.pipeline.frame_handler" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "plsvo_tpu")]


def test_cli_trajectory_ate_bounded(cli_run):
    data_dir, traj_path, _, proc = cli_run
    assert proc.returncode == 0, proc.stderr[-2000:]
    est = trajectory.read_tum(traj_path)
    gt = trajectory.read_tum(os.path.join(data_dir, "groundtruth.txt"))
    assert len(est) == 40, f"expected 40 trajectory rows, got {len(est)}"
    est_pos = np.stack([p for _, p, _ in est])
    gt_pos = np.stack([p for _, p, _ in gt])[: len(est_pos)]
    moved = np.linalg.norm(est_pos - est_pos[0], axis=-1) > 1e-9
    assert moved.sum() > 20, "tracking never left bootstrap"
    ate = trajectory.ate_rmse(est_pos[moved], gt_pos[moved], with_scale=True)
    # tests/test_cli_e2e.py's bound
    assert ate < 0.007, f"CLI ATE {ate}"


def test_cli_metrics_schema(cli_run):
    _, _, metrics_path, proc = cli_run
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [json.loads(line) for line in open(metrics_path)]
    assert len(rows) == 40
    assert {"frame", "stage", "quality", "n_pt", "n_seg", "keyframe",
            "proc_ms"} <= set(rows[0])
    assert any(r["keyframe"] for r in rows), "no keyframe ever selected"
