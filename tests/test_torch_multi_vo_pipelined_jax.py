"""One comparison of the port's pipelined BatchedVO (vmap mode, depth 3)
with the JAX package's on the CPU, on tests/test_multi_vo.py's B = 2
sequences, held by trajectory error as the single-sequence pipelined tests
hold it: the port's stale-seed guard (`>=`) differs from the reference's,
so the two pipelined runs may part after a keyframe's seed install. Per
sequence both bootstrap at the same frame, and the port's Sim3 ATE over
its DEFAULT frames stays below max(0.006, 1.2 x JAX's on the same
frames)."""
import numpy as np
import torch

from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_tpu.config import fast_config
from plsvo_tpu.parallel.multi_vo import BatchedVO as JBVO
from plsvo_tpu.utils import trajectory

from test_multi_vo import CAM, make_sequences
from test_torch_multi_vo import B, port_batched, run_batched
from test_torch_multi_vo_pipelined import default_ids, pipelined
from test_torch_pipeline import centers

torch.set_num_threads(1)


def _ate(results, b, n):
    gt = np.stack([np.asarray([0.025 * i, 0.004 * b * i, -2.0])
                   for i in range(n)])
    ids = default_ids(results)
    est = centers([r for r in results if r.stage == tfh.STAGE_DEFAULT])
    return trajectory.ate_rmse(est.astype(np.float64), gt[ids])


def test_pipelined_vmap_tracks_like_jax():
    seqs = make_sequences(np.random.default_rng(0), B=B)
    n = len(seqs[0])
    tres = run_batched(port_batched(pipelined(fast_config())), seqs)
    jres = run_batched(JBVO(CAM, pipelined(fast_config()), B, mode="vmap"),
                       seqs)
    for b in range(B):
        assert default_ids(tres[b])[0] == default_ids(jres[b])[0]
        a_t, a_j = _ate(tres[b], b, n), _ate(jres[b], b, n)
        assert a_t < max(0.006, 1.2 * a_j), (b, a_t, a_j)
