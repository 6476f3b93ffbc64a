"""chip_smoke.py keeps the inputs of a K2 launch that fails its gate
(`k2_gate` -> `save_k2_launch`, under chiprun_out/ on the card), and
`k2_replay` replays such a file on the CPU: the plain twin's result and
its iterates. Here a planted launch (tests/test_torch_k2_gate.py's mixed
problem, N = 256) with a planted fault: one converged row's uv moved by
0.0082 px, the size of the one row an earlier card run failed on. The gate fails,
leaves the file, and the replay gives back the inputs and the plain twin's
path exactly."""
import json

import numpy as np
import pytest
import torch

import chip_smoke
from plsvo_torch.ops import mixed_align as tma

from test_torch_k2_gate import _k2_args


def test_failing_launch_is_kept_and_replays(tmp_path, monkeypatch):
    args, kw = _k2_args()
    out_p = tma.mixed_align_plain(*args, **kw)
    uv = out_p[0].clone()
    r = int(torch.nonzero(out_p[1])[0, 0])
    uv[r, 0] += 0.0082
    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(chip_smoke.save_k2_launch, "__defaults__",
                        (str(tmp_path),))
    with pytest.raises(SystemExit):
        chip_smoke.k2_gate(args, kw, (uv, out_p[1], out_p[2]), out_p,
                           "reproject", "lines")
    (path,) = tmp_path.glob("k2_fail_lines_reproject_N256_*.npz")
    rep = chip_smoke.k2_replay(str(path))
    assert rep["meta"]["N"] == 256 and rep["meta"]["site"] == "reproject"
    assert rep["meta"]["kw"] == json.loads(json.dumps(kw))
    assert "differ" in rep["meta"]["problem"] or "row" in rep["meta"]["problem"]
    for a, b in zip(rep["args"], args):
        assert torch.equal(a, b.cpu())
    for a, b in zip(rep["plain"], out_p):
        assert torch.equal(a, b)
    # the replayed iterates end where the plain twin's loop stopped
    stop = rep["stop"]
    conv = out_p[1]
    assert bool((stop[conv] > 0).all())
    it = rep["uv_iterates"][stop[conv], torch.nonzero(conv)[:, 0]]
    assert torch.allclose(it, out_p[0][conv], atol=1e-6)


def test_passing_launch_leaves_nothing(tmp_path, monkeypatch):
    args, kw = _k2_args()
    out_p = tma.mixed_align_plain(*args, **kw)
    monkeypatch.setattr(chip_smoke.save_k2_launch, "__defaults__",
                        (str(tmp_path),))
    chip_smoke.k2_gate(args, kw, out_p, out_p, "seeds", "batched")
    assert not list(tmp_path.iterdir())
