"""The port's sharded_sparse_align (the batch of sequences split over an
8-shard CPU mesh, no communication) against its own batched_sparse_align
(atol 1e-5, tests/test_batched.py's bar) and against the JAX package's
sharded_sparse_align on its 8 virtual CPU devices, on
tests/test_batched.py's B = 8 fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from plsvo_torch.ops import sparse_align as tsa
from plsvo_torch.parallel import batched as tbatched
from plsvo_torch.parallel.mesh import Mesh
from plsvo_tpu.parallel import batched as jbatched

from test_batched import CAM, make_batch

torch.set_num_threads(1)


def T(a):
    return None if a is None else torch.as_tensor(np.array(a))


def test_sharded_align_matches_batched_and_jax():
    B = 8
    pyr_r, pyr_c, pts, segs, _, _ = make_batch(np.random.default_rng(0), B)
    R0, t0 = jnp.tile(jnp.eye(3)[None], (B, 1, 1)), jnp.zeros((B, 3))
    cam = tuple(float(np.asarray(v)) for v in (CAM.fx, CAM.fy, CAM.cx, CAM.cy))
    args = ([T(p) for p in pyr_r], [T(p) for p in pyr_c],
            tsa.AlignPoints(*[T(a) for a in pts]),
            tsa.AlignSegments(*[T(a) for a in segs]), T(R0), T(t0)) + cam
    mesh = Mesh(["cpu"] * 8, ("seq",))
    out_s = tbatched.sharded_sparse_align(mesh, "seq", *args)
    out_b = tbatched.batched_sparse_align(*args)
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("seq",))
    out_j = jbatched.sharded_sparse_align(jmesh, "seq", pyr_r, pyr_c, pts,
                                          segs, R0, t0, CAM.fx, CAM.fy,
                                          CAM.cx, CAM.cy)
    for ref in (out_b, out_j):
        ref = [r.numpy() if torch.is_tensor(r) else np.asarray(r) for r in ref]
        np.testing.assert_allclose(out_s[0].numpy(), ref[0], atol=1e-5)
        np.testing.assert_allclose(out_s[1].numpy(), ref[1], atol=1e-5)
        for got, want in zip(out_s[2:], ref[2:]):
            np.testing.assert_array_equal(got.numpy(), want)
    # two shards, four sequences each
    out_2 = tbatched.sharded_sparse_align(Mesh(["cpu"] * 2, ("seq",)), "seq",
                                          *args)
    for a, b in zip(out_2[:2], out_s[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    for a, b in zip(out_2[2:], out_s[2:]):
        assert torch.equal(a, b)
