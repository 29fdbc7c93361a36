"""Synthetic rendered world for end-to-end SLAM tests.

Renders a random 3D point field as small textured blobs (numpy rasterizer,
tests/raster.py); camera follows a smooth trajectory. Ground-truth poses let tests score ATE without
any external dataset (EuRoC is not available in this environment).
"""

from __future__ import annotations

import numpy as np

import raster


class SynthWorld:
    def __init__(self, seed=0, n_points=2500, w=640, h=480,
                 fx=400.0, fy=400.0, motion="default", subpix=False):
        # subpix: draw anti-aliased blobs with 1/16-pixel centers.
        # Integer-quantized centers make descriptors flicker frame to
        # frame, which collapses ref-KF matches and forces a keyframe
        # every ~1.5 frames — an order of magnitude denser than EuRoC's
        # ~1 KF / 10 frames. Subpixel rendering restores realistic
        # descriptor persistence (used by the EuRoC-cadence bench config;
        # default False keeps the long-standing test/golden imagery).
        self.subpix = subpix
        self.motion = motion
        self.rng = np.random.default_rng(seed)
        self.w, self.h = w, h
        self.fx, self.fy = fx, fy
        self.cx, self.cy = w / 2.0, h / 2.0
        if motion == "tour":
            # Cylindrical band of points around the camera's circular path
            # (motion="tour"): the camera yaws outward along the orbit, so
            # each frame sees only a ~40 deg arc of the ring — covisibility
            # BREAKS with arc distance (unlike the "loop" slab world where
            # the whole field stays in view and no loop can ever emerge).
            # A full revolution revisits the start arc through place
            # recognition only: the emergent loop-closure world.
            phi = self.rng.uniform(0, 2 * np.pi, n_points)
            r_p = self.TOUR_R_PTS + self.rng.uniform(-1.5, 1.5, n_points)
            self.pts = np.stack([
                r_p * np.sin(phi),
                self.rng.uniform(-3.0, 3.0, n_points),
                -r_p * np.cos(phi)], -1)
        else:
            # Point field in a broad slab in front of the trajectory.
            self.pts = np.stack([
                self.rng.uniform(-8, 12, n_points),
                self.rng.uniform(-5, 5, n_points),
                self.rng.uniform(3, 9, n_points)], -1)
        self.intens = self.rng.uniform(60, 255, n_points)
        self.sizes = self.rng.integers(3, 9, n_points)
        self.shapes = self.rng.integers(0, 3, n_points)
        # Distinctive per-blob satellite pattern: 4 surrounding dots with
        # random offsets/intensities make local neighborhoods unique, so the
        # nearest/second-nearest ratio test keeps true matches.
        self.sat_off = self.rng.uniform(-2.5, 2.5, (n_points, 4, 2))
        self.sat_int = self.rng.uniform(40, 255, (n_points, 4))

    TOUR_R_CAM = 6.0   # camera orbit radius (motion="tour")
    TOUR_R_PTS = 11.0  # point-ring radius; wall distance ~5 m

    def feature_points(self) -> np.ndarray:
        """All rendered 3D feature locations: blob centers plus the four
        satellite dots per blob at their effective 3D positions.

        Satellites are drawn at pixel offsets ``sat_off * r`` with
        ``r ≈ size * 8 / z``, so their image offset is ∝ 1/z — i.e. each
        satellite behaves as a FIXED 3D point at a lateral offset of
        ``sat_off * size * 8 / f`` meters from its blob center. FAST corners
        fire on satellites and blob rims, NOT blob centers, so map-quality
        metrics must score landmarks against this set (centers alone have a
        ~0.3 m error floor from the offset geometry, masking real drift)."""
        ctr = self.pts
        off = self.sat_off * self.sizes[:, None, None] * 8.0  # px at z=1
        sat = ctr[:, None, :].repeat(4, 1).copy()
        sat[..., 0] += off[..., 0] / self.fx * ctr[:, None, 2]
        sat[..., 1] += off[..., 1] / self.fy * ctr[:, None, 2]
        return np.concatenate([ctr, sat.reshape(-1, 3)], 0)

    def trajectory(self, t: float):
        """GT (pos, vel, acc, R_wc) at time t; analytic derivatives.

        motion="default": smooth sideways arc + slight yaw (the original
        visual test path). motion="excited": extra sinusoidal acceleration
        so scale/gravity are observable for visual-inertial tests.
        """
        from scipy.spatial.transform import Rotation
        if getattr(self, "motion", "default") == "tour":
            # Circular tour INSIDE the point ring, yawing outward: the
            # camera looks radially at the nearby wall arc, so the visible
            # sector advances with the orbit and first-lap structure leaves
            # view entirely until the revolution completes. Vertical bob
            # keeps the IMU excited.
            T = getattr(self, "loop_period", 60.0)
            w = 2 * np.pi / T
            th = w * t
            # Radial pulse + vertical bob at ~1 rad/s give the accelerometer
            # sub-metre-period excitation (mono-inertial scale observability)
            # without disturbing the slow outward-yawing orbit.
            Rc, Ar, wr = self.TOUR_R_CAM, 0.25, 1.5
            Ay, wy = 0.15, 1.2
            r = Rc + Ar * np.sin(wr * t)
            dr = Ar * wr * np.cos(wr * t)
            ddr = -Ar * wr * wr * np.sin(wr * t)
            s, c = np.sin(th), np.cos(th)
            pos = np.array([r * s, Ay * np.sin(wy * t), -r * c])
            vel = np.array([dr * s + r * w * c,
                            Ay * wy * np.cos(wy * t),
                            -dr * c + r * w * s])
            acc = np.array([ddr * s + 2 * dr * w * c - r * w * w * s,
                            -Ay * wy * wy * np.sin(wy * t),
                            -ddr * c + 2 * dr * w * s + r * w * w * c])
            # Optical axis = outward radial direction (sin th, 0, -cos th).
            R_wc = Rotation.from_euler("y", np.pi - th).as_matrix()
            return pos, vel, acc, R_wc
        if getattr(self, "motion", "default") == "loop":
            # Closed orbit revisiting its start every LOOP_PERIOD seconds
            # (loop-closure / soak sequences). Lateral ellipse + vertical
            # bob in front of the point slab; yaw stays small so the field
            # remains in view all the way around.
            T = getattr(self, "loop_period", 60.0)
            w = 2 * np.pi / T
            th = w * t
            A, B, C = 3.0, 1.2, 0.4
            pos = np.array([A * np.sin(th),
                            C * np.sin(2 * th),
                            B * (1 - np.cos(th))])
            vel = np.array([A * w * np.cos(th),
                            2 * C * w * np.cos(2 * th),
                            B * w * np.sin(th)])
            acc = np.array([-A * w * w * np.sin(th),
                            -4 * C * w * w * np.sin(2 * th),
                            B * w * w * np.cos(th)])
            yaw = 0.15 * np.sin(th)
            pitch = 0.05 * np.sin(2 * th)
            R_wc = Rotation.from_euler("yx", [yaw, pitch]).as_matrix()
            return pos, vel, acc, R_wc
        if getattr(self, "motion", "default") == "excited":
            pos = np.array([0.9 * t + 0.3 * np.sin(1.5 * t),
                            0.4 * np.sin(0.8 * t),
                            0.08 * t + 0.1 * np.sin(1.2 * t)])
            vel = np.array([0.9 + 0.45 * np.cos(1.5 * t),
                            0.32 * np.cos(0.8 * t),
                            0.08 + 0.12 * np.cos(1.2 * t)])
            acc = np.array([-0.675 * np.sin(1.5 * t),
                            -0.256 * np.sin(0.8 * t),
                            -0.144 * np.sin(1.2 * t)])
        else:
            pos = np.array([0.9 * t, 0.2 * np.sin(0.5 * t), 0.08 * t])
            vel = np.array([0.9, 0.1 * np.cos(0.5 * t), 0.08])
            acc = np.array([0.0, -0.05 * np.sin(0.5 * t), 0.0])
        yaw = 0.04 * t
        pitch = 0.02 * np.sin(0.8 * t)
        R_wc = Rotation.from_euler("yx", [yaw, pitch]).as_matrix()
        return pos, vel, acc, R_wc

    def pose(self, t: float):
        """GT world->cam pose at time t."""
        cam_pos, _, _, R_wc = self.trajectory(t)
        R_cw = R_wc.T
        t_cw = -R_cw @ cam_pos
        return R_cw.astype(np.float32), t_cw.astype(np.float32)

    GRAVITY_W = np.array([0.0, 0.0, -9.81])

    def imu(self, t0: float, t1: float, freq: float = 200.0,
            gyro_noise: float = 0.0, acc_noise: float = 0.0,
            rng=None):
        """Synthesize body-frame IMU samples with t in (t0, t1].

        Body frame == camera frame (T_bc = I). Gyro from numeric rotation
        differencing; accelerometer = R_wb^T (a_w - g_w).
        """
        from scipy.spatial.transform import Rotation
        k0 = int(np.floor(t0 * freq)) + 1
        k1 = int(np.floor(t1 * freq))
        ts = np.arange(k0, k1 + 1, dtype=np.float64) / freq
        gyr = np.zeros((len(ts), 3), np.float32)
        acc = np.zeros((len(ts), 3), np.float32)
        h = 1e-5
        for i, t in enumerate(ts):
            _, _, a_w, R_wb = self.trajectory(t)
            _, _, _, R_wb2 = self.trajectory(t + h)
            gyr[i] = Rotation.from_matrix(R_wb.T @ R_wb2).as_rotvec() / h
            acc[i] = R_wb.T @ (a_w - self.GRAVITY_W)
        if rng is not None and (gyro_noise > 0 or acc_noise > 0):
            gyr = gyr + rng.normal(0, gyro_noise, gyr.shape)
            acc = acc + rng.normal(0, acc_noise, acc.shape)
        return ts, gyr.astype(np.float32), acc.astype(np.float32)

    def render(self, t: float) -> np.ndarray:
        """(h, w) float32 frame at time t: blobs drawn far to near over a
        flat background, then a 3x3 Gaussian blur (tests/raster.py)."""
        R, tt = self.pose(t)
        pc = self.pts @ R.T + tt
        z = pc[:, 2]
        vis = z > 0.5
        u = self.fx * pc[:, 0] / np.maximum(z, 1e-6) + self.cx
        v = self.fy * pc[:, 1] / np.maximum(z, 1e-6) + self.cy
        img = np.full((self.h, self.w), 30, np.uint8)
        order = np.argsort(-z)  # far first, near drawn on top
        if self.subpix:
            # 1/16-pixel geometry (stable descriptors across frames).
            S = 16
            for i in order:
                if not vis[i]:
                    continue
                uf, vf = float(u[i]), float(v[i])
                if not (-10 <= uf < self.w + 10 and -10 <= vf < self.h + 10):
                    continue
                rf = max(3.0, self.sizes[i] * 8.0 / z[i])
                r16 = int(round(rf * S))
                raster.fill_circle_aa(img, int(round(uf * S)),
                                      int(round(vf * S)), r16,
                                      int(self.intens[i]))
                for s in range(4):
                    su = int(round((uf + self.sat_off[i, s, 0] * rf) * S))
                    sv = int(round((vf + self.sat_off[i, s, 1] * rf) * S))
                    raster.fill_circle_aa(img, su, sv, max(S, r16 // 3),
                                          int(self.sat_int[i, s]))
            return raster.gaussian_blur3(img).astype(np.float32)
        for i in order:
            if not vis[i]:
                continue
            ui, vi = int(round(u[i])), int(round(v[i]))
            if not (-10 <= ui < self.w + 10 and -10 <= vi < self.h + 10):
                continue
            r = max(3, int(round(self.sizes[i] * 8.0 / z[i])))
            val = int(self.intens[i])
            if self.shapes[i] == 0:
                raster.paint(img, raster.circle_mask(r), ui, vi, val)
            elif self.shapes[i] == 1:
                raster.fill_rect(img, ui - r, vi - r, ui + r, vi + r, val)
            else:
                raster.paint(img, raster.triangle_mask(r), ui, vi, val)
            # Satellites scale with the blob (attached to the same 3D point).
            for s in range(4):
                su = int(round(ui + self.sat_off[i, s, 0] * r))
                sv = int(round(vi + self.sat_off[i, s, 1] * r))
                raster.paint(img, raster.circle_mask(max(1, r // 3)), su, sv,
                             int(self.sat_int[i, s]))
        return raster.gaussian_blur3(img).astype(np.float32)
