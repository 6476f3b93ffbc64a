"""The plain reference that decides `correct`.

Plain PyTorch and NumPy; it imports nothing of the program. It judges
what the timed path produced against what the benchmark itself knows:

- poses: the orbit the frames were rendered from. Monocular VO has no
  metric scale, so each frame-to-frame motion is compared after a scale
  taken from the motions around it (relative pose error, RPE);
- keyframes after local BA and the map's landmarks: the live keyframes'
  camera centres are fitted to the orbit by a similarity (Umeyama), and
  every live landmark, carried by the same similarity, has to lie on the
  plane z = 0;
- kernel K1 (FAST mask and Shi-Tomasi score) and the pyramid it scores,
  recomputed from the rendered frame, and kernel K2 (the mixed 2-D/1-D
  alignment loop) re-run on the inputs of the call, the loop written out
  here once more. K2's inputs (patches warped from keyframes) are the
  program's own state: this is the one place where the reference follows
  the program step by step.

`numbers` reduces a run's outputs to the numbers compared; `control`
builds the same outputs from the reference itself in bfloat16, and
`frozen` from the reference with every pose held at the first and
every keyframe at the oldest.
"""
from __future__ import annotations

import math

import numpy as np
import torch

RPE_SCALE_HALF_WINDOW = 25  # frame pairs on each side that give the scale

_FAST_RING = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


# -- geometry -------------------------------------------------------------
def world_to_cam(R_w_c, t_w_c):
    """(R_c_w, t_c_w) of camera-to-world poses (..., 3, 3), (..., 3)."""
    R = np.swapaxes(R_w_c, -1, -2)
    return R, -np.einsum("...ij,...j->...i", R, t_w_c)


def centres(R_c_w, t_c_w):
    return -np.einsum("...ji,...j->...i", R_c_w, t_c_w)


def _angle_deg(R):
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) * 0.5
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def relative_pose_errors(fids, R_est, t_est, R_gt, t_gt):
    """Frame-to-frame pose errors over consecutive frame ids. Inputs are
    world-to-camera poses in float64, the estimate in its own world and
    scale. Returns (translation errors in the orbit's metres, rotation
    errors in degrees), one per consecutive pair."""
    fids = np.asarray(fids)
    pair = np.where(np.diff(fids) == 1)[0]
    if len(pair) == 0:
        return np.zeros(0), np.zeros(0), np.zeros(0)
    a, b = pair, pair + 1

    def rel(R, t):
        Rr = R[b] @ np.swapaxes(R[a], -1, -2)
        return Rr, t[b] - np.einsum("nij,nj->ni", Rr, t[a])

    Re, te = rel(R_est, t_est)
    Rg, tg = rel(R_gt, t_gt)
    ne, ng = np.linalg.norm(te, axis=1), np.linalg.norm(tg, axis=1)
    ratio = np.where(ne > 1e-12, ng / np.maximum(ne, 1e-12), np.nan)
    h = RPE_SCALE_HALF_WINDOW
    scale = np.empty(len(pair))
    for i in range(len(pair)):
        r = ratio[max(0, i - h): i + h + 1]
        r = r[np.isfinite(r)]
        scale[i] = np.median(r) if len(r) else 1.0
    t_err = np.linalg.norm(scale[:, None] * te - tg, axis=1)
    r_err = _angle_deg(Re @ np.swapaxes(Rg, -1, -2))
    cos = (te * tg).sum(1) / np.maximum(ne * ng, 1e-300)
    d_err = np.degrees(np.arccos(np.clip(np.where(ne > 1e-12, cos, -1.0),
                                         -1.0, 1.0)))
    return t_err, r_err, d_err


def umeyama(src, dst):
    """Similarity (s, R, t) that takes points src (N, 3) onto dst (N, 3)
    in the least-squares sense."""
    ms, md = src.mean(0), dst.mean(0)
    xs, xd = src - ms, dst - md
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var, 1e-300))
    return s, R, md - s * R @ ms


# -- kernel K1 and the pyramid ---------------------------------------------
def half_sample(img):
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    x = img[..., : h2 * 2, : w2 * 2].reshape(img.shape[:-2] + (h2, 2, w2, 2))
    return (((x[..., 0, :, 0] + x[..., 0, :, 1]) + x[..., 1, :, 0])
            + x[..., 1, :, 1]) / 4


def fast_mask(img, threshold):
    """FAST-10 on the wrapped 16-pixel ring: >= 10 contiguous ring pixels
    all brighter than centre + threshold or all darker than centre -
    threshold; a 3-pixel border cleared."""
    ring = torch.stack([torch.roll(img, (-dy, -dx), (0, 1))
                        for dx, dy in _FAST_RING])
    out = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    for m in (ring > img + threshold, ring < img - threshold):
        for i in range(16):
            run = m[i]
            for k in range(1, 10):
                run = run & m[(i + k) % 16]
            out |= run
    H, W = img.shape
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    return out & (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)


def _box_sum(x, half):
    k = 2 * half
    cs = torch.cumsum(x, dim=-2)
    cs = torch.cat([torch.zeros_like(cs[..., :1, :]), cs], -2)
    xs = cs[..., k:, :] - cs[..., :-k, :]
    c = torch.cumsum(xs, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :, :1]), c], -1)
    out = c[..., :, k:] - c[..., :, :-k]
    H, W = x.shape[-2], x.shape[-1]
    return torch.nn.functional.pad(
        out, (half, W - out.shape[-1] - half, half, H - out.shape[-2] - half))


def shi_tomasi(img, half=4):
    """Minimum eigenvalue of the structure tensor of wrapped central
    differences over an 8x8 box, / (2 * box area)."""
    dx = 0.5 * (torch.roll(img, -1, -1) - torch.roll(img, 1, -1))
    dy = 0.5 * (torch.roll(img, -1, -2) - torch.roll(img, 1, -2))
    sxx, syy, sxy = (_box_sum(dx * dx, half), _box_sum(dy * dy, half),
                     _box_sum(dx * dy, half))
    tr = sxx + syy
    disc = torch.sqrt((tr * tr * 0.25 - (sxx * syy - sxy * sxy)).clamp_min(0.0))
    return (0.5 * tr - disc) / (2.0 * (2.0 * half) ** 2)


def k1_reference(level0, n_levels, threshold, dtype=torch.float32):
    """The pyramid of a frame and K1's (mask, score) of each level,
    computed in `dtype` (scores returned in float32)."""
    pyr = [level0.to(dtype)]
    for _ in range(1, n_levels):
        pyr.append(half_sample(pyr[-1]))
    outs = [(fast_mask(p, threshold), shi_tomasi(p).float()) for p in pyr]
    return [p.float() for p in pyr], outs


# -- kernel K2 ---------------------------------------------------------------
def _patches(win, corner, uv, P, wh):
    N, wp, _ = win.shape
    S = wp - P
    first = uv - (P / 2.0 - 0.5)
    t0 = first - corner
    i0 = torch.floor(t0)
    f = t0 - i0
    iu, iv = i0[:, 0], i0[:, 1]
    ok = (iu >= 0) & (iv >= 0) & (iu <= S - 1) & (iv <= S - 1)
    iuc, ivc = iu.clamp(0, S - 1).long(), iv.clamp(0, S - 1).long()
    d = torch.arange(P + 1, device=win.device)
    n = torch.arange(N, device=win.device)
    sel = win[n[:, None, None], (ivc[:, None] + d)[:, :, None],
              (iuc[:, None] + d)[:, None, :]]
    fv, fu = f[:, 1][:, None, None], f[:, 0][:, None, None]
    rows = (1 - fv) * sel[:, :P, :] + fv * sel[:, 1:, :]
    patch = (1 - fu) * rows[:, :, :P] + fu * rows[:, :, 1:]
    au0, av0 = torch.floor(first[:, 0]), torch.floor(first[:, 1])
    ok = (ok & (au0 >= 0) & (av0 >= 0) & (au0 + P <= wh[:, 0] - 1)
          & (av0 + P <= wh[:, 1] - 1))
    return patch.reshape(N, P * P), ok


def k2_reference(inputs, kw, dtype=torch.float32):
    """The alignment loop of K2 on a call's inputs, in `dtype`: (uv (N, 2),
    converged (N,), mean_diff (N,), rows active before each iteration)."""
    (win, corner, ref, rdx, rdy, dgrad, h3inv, h1inv, d, is_1d, uv0, wh,
     valid) = inputs
    f = [x.to(dtype) for x in (win, corner, ref, rdx, rdy, dgrad, h3inv,
                               h1inv, d, uv0, wh)]
    win, corner, ref, rdx, rdy, dgrad, h3inv, h1inv, d, uv, wh = f
    N = win.shape[0]
    P = kw["patch_size"]
    h3inv, h1inv = h3inv.reshape(N, 3, 3), h1inv.reshape(N, 2, 2)
    md = torch.zeros(N, dtype=dtype, device=win.device)
    conv = torch.zeros(N, dtype=torch.bool, device=win.device)
    active_counts = []
    for _ in range(kw["n_iter"]):
        cur, in_frame = _patches(win, corner, uv, P, wh)
        active = valid & in_frame & ~conv
        n_active = int(active.sum())
        active_counts.append(n_active)
        if n_active == 0:
            break
        r = cur - ref + md[:, None]
        b3 = torch.stack([(rdx * r).sum(-1), (rdy * r).sum(-1), r.sum(-1)], -1)
        u3 = (h3inv @ b3[..., None])[..., 0]
        b1 = torch.stack([(dgrad * r).sum(-1), r.sum(-1)], -1)
        u1 = (h1inv @ b1[..., None])[..., 0]
        d_uv = torch.where(is_1d[:, None], u1[:, 0:1] * d, u3[:, :2])
        d_md = torch.where(is_1d, u1[:, 1], u3[:, 2])
        step = torch.where(is_1d, u1[:, 0].abs(),
                           torch.linalg.norm(u3[:, :2], dim=-1))
        uv = torch.where(active[:, None], uv - d_uv, uv)
        md = torch.where(active, md - d_md, md)
        conv = conv | (active & (step < kw["conv_eps"]))
    _, ok = _patches(win, corner, uv, P, wh)
    return uv.float(), conv & valid & ok, md.float(), active_counts


# -- the numbers compared ----------------------------------------------------
def pose_numbers(streams, truth):
    """Relative pose errors over every stream's delivered frames: the
    largest and the root mean square of the translation error (mm), of
    the rotation error and of the direction of travel (degrees)."""
    errs = [[], [], []]
    for k, s in enumerate(streams):
        if len(s["fids"]) < 2:
            continue
        idx = (np.asarray(s["fids"]) + truth["offsets"][k]) % truth["period"]
        Rg, tg = world_to_cam(truth["R_w_c"][idx], truth["t_w_c"][idx])
        for acc, e in zip(errs, relative_pose_errors(s["fids"], s["R"], s["t"],
                                                      Rg, tg)):
            acc.append(e)
    t_err, r_err, d_err = [np.concatenate(e) if e else np.zeros(0)
                           for e in errs]
    if len(t_err) == 0:
        return {k: math.inf for k in (
            "rpe_t_max_mm", "rpe_t_rms_mm", "rpe_r_max_deg", "rpe_r_rms_deg",
            "rpe_dir_rms_deg")}

    def rms(x):
        return float(np.sqrt((x ** 2).mean()))

    return {"rpe_t_max_mm": 1e3 * float(t_err.max()),
            "rpe_t_rms_mm": 1e3 * rms(t_err),
            "rpe_r_max_deg": float(r_err.max()), "rpe_r_rms_deg": rms(r_err),
            "rpe_dir_rms_deg": rms(d_err)}


def map_numbers(streams, truth):
    """Keyframes and landmarks of each stream's map at the end of the run,
    fitted to the orbit by the similarity of the keyframes' centres."""
    kf_res, kf_rot, lm_d = [], [], []
    for k, s in enumerate(streams):
        m = s["map"]
        if len(m["kf_fids"]) < 3:
            return {k: math.inf for k in (
                "kf_rel_rot_rms_deg", "kf_centre_max_mm", "kf_centre_rms_mm",
                "landmark_plane_p90_mm", "landmark_plane_med_mm")}
        idx = (np.asarray(m["kf_fids"]) + truth["offsets"][k]) % truth["period"]
        c_gt = truth["t_w_c"][idx]
        c_est = centres(m["kf_R"], m["kf_t"])
        sc, R, t = umeyama(c_est, c_gt)
        res = np.linalg.norm(sc * c_est @ R.T + t - c_gt, axis=1)
        kf_res.append(res)
        order = np.argsort(m["kf_fids"])
        Re, Rg = m["kf_R"][order], world_to_cam(truth["R_w_c"][idx[order]],
                                                 truth["t_w_c"][idx[order]])[0]
        rel_e = Re[1:] @ np.swapaxes(Re[:-1], -1, -2)
        rel_g = Rg[1:] @ np.swapaxes(Rg[:-1], -1, -2)
        kf_rot.append(_angle_deg(rel_e @ np.swapaxes(rel_g, -1, -2)))
        lm = m["landmarks"]
        if len(lm):
            lm_d.append(np.abs((sc * lm @ R.T + t)[:, 2]))
    d = np.concatenate(lm_d) if lm_d else np.zeros(0)
    res, rot = np.concatenate(kf_res), np.concatenate(kf_rot)
    return {"kf_rel_rot_rms_deg": float(np.sqrt((rot ** 2).mean())),
            "kf_centre_max_mm": 1e3 * float(res.max()),
            "kf_centre_rms_mm": 1e3 * float(np.sqrt((res ** 2).mean())),
            "landmark_plane_p90_mm": (1e3 * float(np.percentile(d, 90))
                                      if len(d) else math.inf),
            "landmark_plane_med_mm": (1e3 * float(np.median(d))
                                      if len(d) else math.inf)}


def _groups(imgs, frame_shape):
    """(start, n_levels) of each pyramid in a K1 call's image list: a
    pyramid starts at each full-size image."""
    starts = [i for i, im in enumerate(imgs) if tuple(im.shape) == frame_shape]
    return [(a, b - a) for a, b in zip(starts, starts[1:] + [len(imgs)])]


def k1_numbers(calls, frames):
    """Every captured K1 call against the reference of its frame: the
    pyramid the call scored (exact), the corner masks (pixels that
    differ) and the scores (largest error relative to max(|score|, 1))."""
    pyr_err, mask_diff, score_err = 0.0, 0, 0.0
    bad = {"k1_input_err": math.inf, "k1_mask_diff_px": math.inf,
           "k1_score_rel_err": math.inf}
    fp = frames.long().sum((1, 2))
    for imgs, outs, thr in calls:
        groups = _groups(imgs, tuple(frames.shape[1:]))
        if not groups or groups[0][0] != 0:
            return bad
        for a, n in groups:
            level0 = imgs[a]
            hit = torch.nonzero(fp == level0.long().sum())[:, 0]
            src = next((frames[j] for j in hit.tolist()
                        if bool((frames[j].float() == level0).all())), None)
            if src is None:
                return bad
            pyr, ref = k1_reference(src.float(), n, thr)
            for lv in range(n):
                im, (mask, score) = imgs[a + lv], outs[a + lv]
                pyr_err = max(pyr_err, float((im - pyr[lv]).abs().max()))
                mask_diff += int((mask != ref[lv][0]).sum())
                score_err = max(score_err, float(
                    ((score - ref[lv][1]).abs()
                     / ref[lv][1].abs().clamp_min(1.0)).max()))
    return {"k1_input_err": pyr_err, "k1_mask_diff_px": float(mask_diff),
            "k1_score_rel_err": score_err}


def k2_numbers(calls):
    """Every sampled K2 call against the loop re-run on its inputs: rows
    whose converged verdict differs, and the largest uv difference (px)
    over rows converged on both sides."""
    verdict, uv_err = 0, 0.0
    for inputs, kw, (uv, conv, _md) in calls:
        uv_r, conv_r, _, _ = k2_reference(inputs, kw)
        verdict += int((conv != conv_r).sum())
        both = conv & conv_r
        if bool(both.any()):
            uv_err = max(uv_err, float((uv - uv_r)[both].abs().max()))
    return {"k2_verdict_diff_rows": float(verdict), "k2_uv_err_px": uv_err}


def numbers(out, truth):
    """Every number compared, from a run's outputs (see `check.outputs`)."""
    got = {"missing_frames": float(out["missing"])}
    got.update(pose_numbers(out["streams"], truth))
    got.update(map_numbers(out["streams"], truth))
    if out["k1"]:
        got.update(k1_numbers(out["k1"], truth["frames"]))
    if out["k2"]:
        got.update(k2_numbers(out["k2"]))
    return got


# -- the controls -----------------------------------------------------------------
def _orbit_in_program_frame(fids, k, truth, f0):
    """World-to-camera poses of the orbit at frame ids `fids` of stream k,
    in a frame like the program's: frame f0's camera at the origin, the
    plane at depth 1. Returns (R, t, the similarity's (R0, t0, depth))."""
    off, P = truth["offsets"][k], truth["period"]

    def orbit(ids):
        idx = (np.asarray(ids) + off) % P
        return world_to_cam(truth["R_w_c"][idx], truth["t_w_c"][idx])

    R0, t0 = (a[0] for a in orbit([f0]))
    depth = -truth["t_w_c"][(f0 + off) % P][2]
    R, t = orbit(fids)
    Rp = R @ R0.T
    return Rp, (t - np.einsum("nij,j->ni", Rp, t0)) / depth, (R0, t0, depth)


def control(out, truth, dtype=torch.bfloat16):
    """The reference put in the program's place, computed in `dtype`: the
    orbit's poses in the program's frame for every frame the program
    delivered and every live keyframe, each landmark moved onto the
    plane, K1 on the frame's pyramid and K2's loop on the call's inputs,
    all rounded to or computed in `dtype`."""
    def rnd(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(dtype).to(
            torch.float64).numpy()

    streams = []
    for k, s in enumerate(out["streams"]):
        f0 = s["fids"][0] if len(s["fids"]) else 0
        R, t, (R0, t0, depth) = _orbit_in_program_frame(s["fids"], k, truth, f0)
        m = s["map"]
        Rk, tk, _ = _orbit_in_program_frame(m["kf_fids"], k, truth, f0)
        lm = m["landmarks"]
        if len(lm) and len(m["kf_fids"]) >= 3:
            idx = (np.asarray(m["kf_fids"]) + truth["offsets"][k]) % truth["period"]
            sc, Ra, ta = umeyama(centres(m["kf_R"], m["kf_t"]),
                                 truth["t_w_c"][idx])
            on = sc * lm @ Ra.T + ta
            on[:, 2] = 0.0
            lm = rnd((on @ R0.T + t0) / depth)
        streams.append({"fids": s["fids"], "R": rnd(R), "t": rnd(t),
                        "map": {"kf_fids": m["kf_fids"], "kf_R": rnd(Rk),
                                "kf_t": rnd(tk), "landmarks": lm}})
    k1 = []
    for imgs, _, thr in out["k1"]:
        ins, outs = [], []
        for a, n in _groups(imgs, tuple(truth["frames"].shape[1:])):
            pyr, ref = k1_reference(imgs[a], n, thr, dtype)
            ins += pyr
            outs += ref
        k1.append((ins, outs, thr))
    k2 = [(inputs, kw, k2_reference(inputs, kw, dtype)[:3])
          for inputs, kw, _ in out["k2"]]
    return {"missing": out["missing"], "streams": streams, "k1": k1, "k2": k2}


def frozen(out, truth):
    """The reference put in the program's place with the guarantees that
    each pose follows the camera's motion and that the map lies on the
    scene broken, as a step that returns its state unchanged would: every
    frame delivered with the orbit's pose of the stream's first delivered
    frame (float64), and every live keyframe held at the pose of the
    oldest."""
    streams = []
    for k, s in enumerate(out["streams"]):
        f0 = s["fids"][0] if len(s["fids"]) else 0
        R, t, _ = _orbit_in_program_frame(np.full(len(s["fids"]), f0), k,
                                          truth, f0)
        m = dict(s["map"])
        if len(m["kf_fids"]):
            j = int(np.argmin(m["kf_fids"]))
            m["kf_R"] = np.broadcast_to(m["kf_R"][j], m["kf_R"].shape).copy()
            m["kf_t"] = np.broadcast_to(m["kf_t"][j], m["kf_t"].shape).copy()
        streams.append(dict(s, R=R, t=t, map=m))
    return dict(out, streams=streams)
