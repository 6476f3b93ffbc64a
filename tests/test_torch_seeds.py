"""Depth-filter parity between the port and the JAX package on CPU: the
Bayes update, tau, and one combined seed update on a populated table
(point seeds, with and without line seeds in the same batch)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import image as ti
from plsvo_torch.ops import depth_filter as tdf
from plsvo_torch.parallel.mesh import leaves
from plsvo_tpu import image as ji
from plsvo_tpu.camera import PinholeCamera
from plsvo_tpu.ops import depth_filter as jdf
from plsvo_tpu.ops import detection as jd
from plsvo_tpu.ops import lines as jl
from plsvo_tpu.utils import synthetic

CAM = PinholeCamera.create(320, 240, 250.0, 250.0, 160.0, 120.0)


def T(a):
    return torch.as_tensor(np.array(a))


def test_bayes_update_matches_jax(rng):
    n = 256
    x = rng.uniform(0.2, 0.8, n).astype(np.float32)
    tau2 = rng.uniform(1e-5, 1e-2, n).astype(np.float32)
    mu = rng.uniform(0.2, 0.8, n).astype(np.float32)
    sigma2 = rng.uniform(1e-4, 0.1, n).astype(np.float32)
    a = rng.uniform(1, 20, n).astype(np.float32)
    b = rng.uniform(1, 20, n).astype(np.float32)
    zr = rng.uniform(1, 3, n).astype(np.float32)
    oj = jdf.bayes_update(*[jnp.asarray(v) for v in (x, tau2, mu, sigma2, a, b, zr)])
    ot = tdf.bayes_update(*[T(v) for v in (x, tau2, mu, sigma2, a, b, zr)])
    np.testing.assert_array_equal(ot[4].numpy(), np.asarray(oj[4]))
    ok = np.asarray(oj[4])
    # sigma2' is a difference of nearly equal terms: its absolute f32 error
    # (~3e-8) is the bound where it is small
    for u, v in zip(ot[:4], oj[:4]):
        np.testing.assert_allclose(u.numpy()[ok], np.asarray(v)[ok], rtol=1e-4,
                                   atol=1e-7)


def test_compute_tau_matches_jax(rng):
    n = 64
    t = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    f = rng.normal(size=(n, 3)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    z = rng.uniform(1, 4, n).astype(np.float32)
    pea = float(np.arctan(1.0 / (2.0 * 250.0)) * 2.0)
    np.testing.assert_allclose(
        tdf.compute_tau(T(t), T(f), T(z), pea).numpy(),
        np.asarray(jdf.compute_tau(jnp.asarray(t), jnp.asarray(f), jnp.asarray(z),
                                   pea)), rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def seed_problem():
    rng = np.random.default_rng(5)
    scene = synthetic.make_scene(rng, size=1024, texel_size=0.004)
    R0 = np.eye(3, dtype=np.float32)
    t0 = np.array([0.0, 0.0, -2.0], np.float32)
    img0 = np.array(synthetic.render_aa(scene, CAM, R0, t0)[0])
    t1 = t0 + np.asarray([0.06, 0.006, 0.0], np.float32)
    img1 = np.array(synthetic.render_aa(scene, CAM, R0, t1)[0])
    grid = jd.detect_fast_grid(ji.build_pyramid(jnp.asarray(img0), 3), cell_size=20)
    order = np.argsort(-np.asarray(grid.score))[:64]
    uv = np.asarray(grid.uv)[order]
    S = len(uv)
    mu, sigma2, z_range = jdf.seed_init_params(depth_mean=2.2, depth_min=0.9)
    f = np.asarray(CAM.unproject(jnp.asarray(uv)))
    cols = dict(
        kf_idx=np.zeros(S, np.int32), uv=uv.astype(np.float32),
        f=f.astype(np.float32), level=np.asarray(grid.level)[order],
        mu=np.full(S, mu, np.float32) * rng.uniform(0.8, 1.2, S).astype(np.float32),
        sigma2=np.full(S, sigma2, np.float32),
        z_range=np.full(S, z_range, np.float32), a=np.full(S, 10.0, np.float32),
        b=(10.0 + rng.integers(0, 4, S)).astype(np.float32),
        batch_id=np.zeros(S, np.int32), alive=np.asarray(grid.valid)[order])
    # line seeds on the frame's detected segments, endpoint depths spread
    # around the prior as the point seeds' are
    segs = jl.dedup_segments_grid_np(
        jl.detect_segments_tiled(jnp.asarray(img0), n_peaks=64, run_gap_px=3.0,
                                 dist_tol=1.2),
        width=320, height=240, cell_size=25, max_segs=32, min_length=20.0)
    L = 32
    sf = np.asarray(CAM.unproject(jnp.asarray(segs.sp)))
    ef = np.asarray(CAM.unproject(jnp.asarray(segs.ep)))
    ln_cols = dict(
        kf_idx=np.zeros(L, np.int32), s_uv=segs.sp, e_uv=segs.ep,
        sf=sf.astype(np.float32), ef=ef.astype(np.float32),
        level=np.zeros(L, np.int32),
        mu_s=np.float32(mu) * rng.uniform(0.8, 1.2, L).astype(np.float32),
        sigma2_s=np.full(L, sigma2, np.float32),
        z_range_s=np.full(L, z_range, np.float32),
        mu_e=np.float32(mu) * rng.uniform(0.8, 1.2, L).astype(np.float32),
        sigma2_e=np.full(L, sigma2, np.float32),
        z_range_e=np.full(L, z_range, np.float32), a=np.full(L, 10.0, np.float32),
        b=(10.0 + rng.integers(0, 4, L)).astype(np.float32),
        batch_id=np.zeros(L, np.int32), alive=segs.valid)
    return dict(cols=cols, ln_cols=ln_cols, img0=img0, img1=img1, R0=R0, t0=t0,
                t1=t1)


@pytest.mark.parametrize("pt_work,has_ln", [
    pytest.param(0, False, id="0"), pytest.param(24, False, id="24"),
    pytest.param(24, True, id="24-lines")])
def test_update_seeds_combined_matches_jax(seed_problem, pt_work, has_ln):
    p = seed_problem
    cols = p["cols"]
    pyr0_j = ji.build_pyramid(jnp.asarray(p["img0"]), 3)
    pyr1_j = ji.build_pyramid(jnp.asarray(p["img1"]), 3)
    sj = jdf.PointSeeds(**{k: jnp.asarray(v) for k, v in cols.items()})
    st = tdf.PointSeeds(**{k: T(v) for k, v in cols.items()})
    lj = lt = None
    if has_ln:
        lj = jdf.LineSeeds(**{k: jnp.asarray(v) for k, v in p["ln_cols"].items()})
        lt = tdf.LineSeeds(**{k: T(v) for k, v in p["ln_cols"].items()})
    # the line case searches more bands: its batch holds 64 more rows
    kw = dict(has_pt=True, has_ln=has_ln, max_search=64 if has_ln else 16,
              n_epi_steps=128,
              pt_work=pt_work)
    rj, lrj = jdf.update_seeds_combined(
        sj, lj, jnp.asarray(p["R0"])[None], jnp.asarray(p["t0"])[None],
        [q[None] for q in pyr0_j], pyr1_j, jnp.asarray(p["R0"]),
        jnp.asarray(p["t1"]), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
        jnp.asarray(0, jnp.int32), **kw)
    kf_flat = ti.pack_pyramid_atlas_flat(
        [q[None] for q in ti.build_pyramid(T(p["img0"]), 3)])
    rt, lrt = tdf.update_seeds_combined(
        st, lt, T(p["R0"])[None], T(p["t0"])[None], kf_flat,
        ti.build_pyramid(T(p["img1"]), 3), T(p["R0"]), T(p["t1"]),
        250.0, 250.0, 160.0, 120.0, 0, **kw)
    for name in ("converged", "matched", "skipped"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)), name)
    np.testing.assert_array_equal(rt.seeds.alive.numpy(), np.asarray(rj.seeds.alive))
    assert np.asarray(rj.matched).sum() >= 10
    live = np.asarray(rj.seeds.alive) | np.asarray(rj.converged)
    for name in ("mu", "sigma2", "a", "b"):
        np.testing.assert_allclose(getattr(rt.seeds, name).numpy()[live],
                                   np.asarray(getattr(rj.seeds, name))[live],
                                   rtol=1e-4, err_msg=name)
    if not has_ln:
        assert lrt is None and lrj is None
        return
    for name in ("converged", "matched", "skipped"):
        np.testing.assert_array_equal(getattr(lrt, name).numpy(),
                                      np.asarray(getattr(lrj, name)), name)
    np.testing.assert_array_equal(lrt.seeds.alive.numpy(),
                                  np.asarray(lrj.seeds.alive))
    # a line updates only when both endpoints match; under this sideways
    # motion many segments run along their epipolar lines
    assert np.asarray(lrj.matched).sum() >= 3
    live = np.asarray(lrj.seeds.alive) | np.asarray(lrj.converged)
    for name in ("mu_s", "sigma2_s", "mu_e", "sigma2_e", "a", "b"):
        np.testing.assert_allclose(getattr(lrt.seeds, name).numpy()[live],
                                   np.asarray(getattr(lrj.seeds, name))[live],
                                   rtol=1e-4, err_msg=name)


def test_update_line_seeds_matches_jax(seed_problem):
    """Line seeds alone: JAX's update_line_seeds (each endpoint in a batch
    of its own) against the port's, the line-only case of
    update_seeds_combined (both endpoints in one batch; without a search
    budget the rows do not interact), which gives the combined path's
    result exactly."""
    p = seed_problem
    lj = jdf.LineSeeds(**{k: jnp.asarray(v) for k, v in p["ln_cols"].items()})
    lt = tdf.LineSeeds(**{k: T(v) for k, v in p["ln_cols"].items()})
    rj = jdf.update_line_seeds(
        lj, jnp.asarray(p["R0"])[None], jnp.asarray(p["t0"])[None],
        [q[None] for q in ji.build_pyramid(jnp.asarray(p["img0"]), 3)],
        ji.build_pyramid(jnp.asarray(p["img1"]), 3), jnp.asarray(p["R0"]),
        jnp.asarray(p["t1"]), CAM.fx, CAM.fy, CAM.cx, CAM.cy,
        jnp.asarray(0, jnp.int32), n_epi_steps=128)
    args = (T(p["R0"])[None], T(p["t0"])[None],
            [q[None] for q in ti.build_pyramid(T(p["img0"]), 3)],
            ti.build_pyramid(T(p["img1"]), 3), T(p["R0"]), T(p["t1"]),
            250.0, 250.0, 160.0, 120.0, 0)
    rt = tdf.update_line_seeds(lt, *args, n_epi_steps=128)
    pt_res, rc = tdf.update_seeds_combined(
        None, lt, *args[:2], ti.pack_pyramid_atlas_flat(args[2]), *args[3:],
        has_pt=False, has_ln=True, n_epi_steps=128)
    assert pt_res is None
    for a, b in zip(leaves(rt), leaves(rc)):
        assert torch.equal(a, b)
    for name in ("converged", "matched"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)), name)
    np.testing.assert_array_equal(rt.seeds.alive.numpy(), np.asarray(rj.seeds.alive))
    assert np.asarray(rj.matched).sum() >= 3
    live = np.asarray(rj.seeds.alive)
    for name in ("mu_s", "sigma2_s", "mu_e", "sigma2_e", "a", "b"):
        np.testing.assert_allclose(getattr(rt.seeds, name).numpy()[live],
                                   np.asarray(getattr(rj.seeds, name))[live],
                                   rtol=1e-4, err_msg=name)
