"""Picker action tools over the PBD cloth simulator; counterpart of
``cloth_splatting_tpu/manipulation/action_space.py``.

``Picker`` (incremental [dx, dy, dz, pick] control of P spherical
grippers), ``PickerPickPlace`` (absolute pick-and-place targets executed as
``delta_move`` increments with a physics step after each) and ``PickerQPG``
(an image-space pick (u, v) plus a relative place, back-projected through
the pinhole camera). A small :class:`PBDScene` owns the ``ClothState`` (on
``device``) and the tools change it. The control logic is host-side numpy,
the JAX package's, line for line; the physics is ``cloth_step_multi``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cloth_splatting_tpu_torch.device import resolve_device
from cloth_splatting_tpu_torch.manipulation.sim import (
    ClothParams,
    ClothState,
    cloth_step_multi,
    make_cloth,
    settle,
)


@dataclasses.dataclass
class Box:
    """Minimal gym.spaces.Box stand-in (bounds + sample)."""

    low: np.ndarray
    high: np.ndarray

    def __post_init__(self):
        self.low = np.asarray(self.low, np.float64)
        self.high = np.asarray(self.high, np.float64)
        self.shape = self.low.shape

    def sample(self, rng: np.random.Generator | None = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        return rng.uniform(self.low, self.high)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return bool(np.all(x >= self.low - 1e-9) and np.all(x <= self.high + 1e-9))


class PBDScene:
    """Owns the cloth state the pickers act on."""

    def __init__(self, nx: int = 12, ny: int = 12, size: float = 0.3,
                 height: float = 0.0, params: ClothParams = ClothParams(),
                 settle_steps: int = 10, device: str | torch.device = "cuda"):
        self.params = params
        self.device = resolve_device(device)
        state, self.cons, self.grid = make_cloth(nx, ny, size, height=height,
                                                 params=params, device=self.device)
        self.state = settle(state, self.cons, n_steps=settle_steps, params=params)
        self.frames: list[np.ndarray] = [self.positions]
        self.recording = False

    @property
    def positions(self) -> np.ndarray:
        return self.state.pos.cpu().numpy()

    def set_positions(self, pos: np.ndarray) -> None:
        self.state = ClothState(
            pos=torch.as_tensor(np.asarray(pos, np.float32), device=self.device),
            vel=self.state.vel)

    def step_sim(self, pinned_idx: np.ndarray, pinned_pos: np.ndarray,
                 pinned_active: np.ndarray) -> None:
        """One physics step with ``pinned_idx`` held at ``pinned_pos``."""
        self.state = cloth_step_multi(
            self.state, self.cons, np.asarray(pinned_idx, np.int64).reshape(-1),
            torch.as_tensor(np.asarray(pinned_pos, np.float32).reshape(-1, 3),
                            device=self.device),
            np.asarray(pinned_active, bool).reshape(-1), self.params)
        if self.recording:
            self.frames.append(self.positions)


class ActionToolBase:
    def reset(self, state):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError


class Picker(ActionToolBase):
    """P spherical grippers with pick/unpick control.

    Action = ``[dx, dy, dz, pick] * num_picker``. Semantics match the
    reference (action_space.py:142-208): pick when flag > 0.5; a picker with
    nothing picked grabs the nearest particle within
    ``picker_threshold + picker_radius + particle_radius``; picked particles
    translate rigidly with their picker; a spring guard reverts moves that
    stretch any picked-picked pair beyond ``spring_coef`` x its initial
    distance. ``step`` moves pickers/particles only — it does not advance
    the simulator (parity with the reference's "does not call pyflex.step()").
    """

    def __init__(self, scene: PBDScene, num_picker: int = 1,
                 picker_radius: float = 0.05, init_pos=(0.0, -0.1, 0.0),
                 picker_threshold: float = 0.005, particle_radius: float = 0.05,
                 picker_low=(-0.4, 0.0, -0.4), picker_high=(0.4, 0.5, 0.4),
                 init_particle_pos: np.ndarray | None = None,
                 spring_coef: float = 1.2, **kwargs):
        self.scene = scene
        self.num_picker = num_picker
        self.picker_radius = picker_radius
        self.picker_threshold = picker_threshold
        self.particle_radius = particle_radius
        self.picker_low = np.array(list(picker_low), np.float64)
        self.picker_high = np.array(list(picker_high), np.float64)
        self.init_pos = np.asarray(init_pos, np.float64)
        self.init_particle_pos = init_particle_pos
        self.spring_coef = spring_coef
        self.picked_particles: list[int | None] = [None] * num_picker
        self.picker_pos = np.tile(self.init_pos, (num_picker, 1))
        space_low = np.array([-0.1, -0.1, -0.1, 0] * num_picker) * 0.1
        space_high = np.array([0.1, 0.1, 0.1, 10] * num_picker) * 0.1
        self.action_space = Box(space_low, space_high)

    # ------------------------------------------------------------- geometry

    def update_picker_boundary(self, picker_low, picker_high) -> None:
        self.picker_low = np.array(picker_low, np.float64).copy()
        self.picker_high = np.array(picker_high, np.float64).copy()

    def _apply_picker_boundary(self, pos: np.ndarray) -> np.ndarray:
        return np.clip(pos, self.picker_low + self.picker_radius,
                       self.picker_high - self.picker_radius)

    def _get_centered_picker_pos(self, center: np.ndarray) -> np.ndarray:
        """Ring of radius sqrt(P-1)*2r around the center (reference
        action_space.py:63-71)."""
        r = np.sqrt(self.num_picker - 1) * self.picker_radius * 2.0
        angles = 2 * np.pi * np.arange(self.num_picker) / self.num_picker
        return np.stack([center[0] + np.sin(angles) * r,
                         np.full(self.num_picker, center[1]),
                         center[2] + np.cos(angles) * r], axis=1)

    def reset(self, center) -> None:
        center = np.asarray(center, np.float64)
        for i in (0, 2):
            offset = center[i] - (self.picker_high[i] + self.picker_low[i]) / 2.0
            self.picker_low[i] += offset
            self.picker_high[i] += offset
        self.picker_pos = self._get_centered_picker_pos(center)
        self.picked_particles = [None] * self.num_picker

    def get_picker_pos(self) -> np.ndarray:
        return self.picker_pos.copy()

    # ----------------------------------------------------------------- step

    def step(self, action: np.ndarray) -> None:
        action = np.reshape(np.asarray(action, np.float64), (-1, 4))
        pick_flag = action[:, 3] > 0.5
        particle_pos = self.scene.positions.astype(np.float64)
        new_picker_pos = self.picker_pos.copy()
        new_particle_pos = particle_pos.copy()

        # un-pick
        for i in range(self.num_picker):
            if not pick_flag[i] and self.picked_particles[i] is not None:
                self.picked_particles[i] = None

        for i in range(self.num_picker):
            new_picker_pos[i] = self._apply_picker_boundary(
                self.picker_pos[i] + action[i, :3])
            if pick_flag[i]:
                if self.picked_particles[i] is None:
                    dists = np.linalg.norm(particle_pos - self.picker_pos[i], axis=1)
                    reach = (self.picker_threshold + self.picker_radius
                             + self.particle_radius)
                    order = np.argsort(dists)
                    for j in order:
                        if dists[j] > reach:
                            break
                        if j not in self.picked_particles:
                            self.picked_particles[i] = int(j)
                            break
                if self.picked_particles[i] is not None:
                    pid = self.picked_particles[i]
                    new_particle_pos[pid] = (particle_pos[pid]
                                             + new_picker_pos[i] - self.picker_pos[i])

        # spring guard: revert over-stretched picked-picked pairs
        if self.init_particle_pos is not None:
            picked = [(i, p) for i, p in enumerate(self.picked_particles)
                      if p is not None]
            for a in range(len(picked)):
                for b in range(a + 1, len(picked)):
                    (ia, pa), (ib, pb) = picked[a], picked[b]
                    init_d = np.linalg.norm(self.init_particle_pos[pa, :3]
                                            - self.init_particle_pos[pb, :3])
                    now_d = np.linalg.norm(new_particle_pos[pa] - new_particle_pos[pb])
                    if now_d >= init_d * self.spring_coef:
                        new_picker_pos[ia] = self.picker_pos[ia].copy()
                        new_picker_pos[ib] = self.picker_pos[ib].copy()
                        new_particle_pos[pa] = particle_pos[pa].copy()
                        new_particle_pos[pb] = particle_pos[pb].copy()

        self.picker_pos = new_picker_pos
        self.scene.set_positions(new_particle_pos)

    # -------------------------------------------------------------- physics

    def _pinned(self):
        """(idx, pos, active) arrays of currently picked particles for the
        simulator (picked particles are kinematically held)."""
        idx = np.array([p if p is not None else 0
                        for p in self.picked_particles], np.int32)
        active = np.array([p is not None for p in self.picked_particles], bool)
        pos = self.scene.positions[idx]
        return idx, pos, active

    def step_sim(self) -> None:
        self.scene.step_sim(*self._pinned())


class PickerPickPlace(Picker):
    """Absolute pick-and-place control: action = [x, y, z, pick] per picker;
    the picker first picks/drops, then moves toward the target in
    ``delta_move`` increments with a physics step per increment, capped at
    300 steps (reference action_space.py:210-276)."""

    def __init__(self, scene: PBDScene, num_picker: int = 1, env=None,
                 picker_low=(-0.4, 0.0, -0.4), picker_high=(0.4, 0.5, 0.4),
                 delta_move: float = 0.01, **kwargs):
        super().__init__(scene, num_picker=num_picker, picker_low=picker_low,
                         picker_high=picker_high, **kwargs)
        self.delta_move = delta_move
        self.env = env
        self.action_space = Box(
            np.array([*list(picker_low), 0.0] * num_picker),
            np.array([*list(picker_high), 1.0] * num_picker))

    def step(self, action: np.ndarray) -> int:
        action = np.reshape(np.asarray(action, np.float64), (-1, 4))
        curr_pos = self.picker_pos.copy()
        end_pos = np.vstack([self._apply_picker_boundary(p)
                             for p in action[:, :3]])
        dist = np.linalg.norm(curr_pos - end_pos, axis=1)
        num_step = np.max(np.ceil(dist / self.delta_move))
        if num_step < 0.1:
            return 0
        delta = (end_pos - curr_pos) / num_step
        norm_delta = np.linalg.norm(delta)
        total_steps = 0
        for _ in range(int(min(num_step, 300))):
            dist = np.linalg.norm(end_pos - self.picker_pos, axis=1)
            if np.all(dist < norm_delta):
                delta = end_pos - self.picker_pos
            super().step(np.hstack([delta, action[:, 3:4]]))
            self.step_sim()
            total_steps += 1
            if np.all(dist < self.delta_move):
                break
        return total_steps

    def get_model_action(self, action: np.ndarray, picker_pos: np.ndarray):
        """The per-increment [dx, dy, dz, pick] actions a GNN rollout would
        see for this pick-and-place (reference action_space.py:253-276).
        Pure kinematics — does not touch the scene."""
        action = np.reshape(np.asarray(action, np.float64), (-1, 4))
        curr_pos = np.array(picker_pos, np.float64).reshape(-1, 3).copy()
        end_pos = np.vstack([self._apply_picker_boundary(p)
                             for p in action[:, :3]])
        dist = np.linalg.norm(curr_pos - end_pos, axis=1)
        num_step = np.max(np.ceil(dist / self.delta_move))
        if num_step < 0.1:
            return [], curr_pos
        delta = (end_pos - curr_pos) / num_step
        norm_delta = np.linalg.norm(delta)
        model_actions = []
        for _ in range(int(min(num_step, 300))):
            dist = np.linalg.norm(end_pos - curr_pos, axis=1)
            if np.all(dist < norm_delta):
                delta = end_pos - curr_pos
            model_actions.append(np.hstack([delta, action[:, 3:4]]))
            curr_pos = curr_pos + delta
            if np.all(dist < self.delta_move):
                break
        return model_actions, curr_pos


class PickerQPG(PickerPickPlace):
    """Image-space pick-and-place: action = (u, v, dx, dy, dz) with (u, v)
    in [-1, 1] pixel-normalized coordinates; the pick point is back-projected
    through the pinhole camera to the plane y = particle_radius, then the
    picker executes hover -> descend+grasp -> move -> drop -> 20 settle
    steps (reference action_space.py:278-395)."""

    def __init__(self, scene: PBDScene, image_size, cam_pos, cam_angle,
                 full: bool = True, **kwargs):
        kwargs.setdefault("num_picker", 1)
        super().__init__(scene, **kwargs)
        assert self.num_picker == 1
        self.image_size = tuple(image_size)
        self.cam_pos = np.asarray(cam_pos, np.float64)
        self.cam_angle = np.asarray(cam_angle, np.float64)
        self.full = full
        self.total_steps = 0
        self.action_space = Box(np.array([-1.0, -1.0, -0.3, 0.0, -0.3]),
                                np.array([1.0, 1.0, 0.3, 0.3, 0.3]))

    @staticmethod
    def _rotation(angle: float, axis) -> np.ndarray:
        axis = np.asarray(axis, np.float64)
        axis = axis / np.linalg.norm(axis)
        c, s = np.cos(angle), np.sin(angle)
        x, y, z = axis
        K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
        R3 = np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)
        R = np.eye(4)
        R[:3, :3] = R3
        return R

    def _intrinsics(self) -> np.ndarray:
        h, w = self.image_size
        fov = np.deg2rad(45)
        f = (h / 2.0) / np.tan(fov / 2.0)
        return np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])

    def _cam_to_world(self) -> np.ndarray:
        yaw, pitch, _ = self.cam_angle
        m1 = self._rotation(-yaw, [0, 1, 0])
        m2 = self._rotation(-pitch - np.pi, [1, 0, 0])
        T = np.eye(4)
        T[:3, 3] = -self.cam_pos
        return np.linalg.inv(m2 @ m1 @ T)

    def _get_world_coor_from_image(self, u: float, v: float) -> np.ndarray:
        K = self._intrinsics()
        M = self._cam_to_world()
        vec = ((u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1])
        # depth such that the back-projected point sits at y = particle_radius
        depth = ((self.particle_radius - M[1, 3])
                 / (vec[0] * M[1, 0] + vec[1] * M[1, 1] + M[1, 2]))
        cam = np.array([vec[0] * depth, vec[1] * depth, depth, 1.0])
        world = M @ cam
        return world[:3]

    def reset(self, *args, **kwargs) -> None:
        self.total_steps = 0
        super().reset(*args, **kwargs)

    def step(self, action: np.ndarray) -> int:
        u, v = action[:2]
        # u is the x-pixel coordinate -> scale by width (image_size is
        # (h, w)); the reference scales u by image_size[0], which only
        # coincides for its square cameras
        u = (u + 1.0) * 0.5 * self.image_size[1]
        v = (v + 1.0) * 0.5 * self.image_size[0]
        x, y, z = self._get_world_coor_from_image(u, v)
        y += 0.01
        dx, dy, dz = action[2:]
        st_high = np.array([x, 0.2, z, 0.0])
        st = np.array([x, y, z, 0.0])
        en = st + np.array([dx, dy, dz, 1.0])
        if not self.full:
            raise NotImplementedError
        self.total_steps += super().step(st_high)
        self.total_steps += super().step(st)
        self.total_steps += super().step(en)
        # drop + settle
        self.picked_particles = [None] * self.num_picker
        for _ in range(20):
            self.step_sim()
        self.total_steps += 20
        return self.total_steps

    def get_model_action(self, action: np.ndarray, curr_pos: np.ndarray):
        u, v = action[:2]
        u = (u + 1.0) * 0.5 * self.image_size[1]
        v = (v + 1.0) * 0.5 * self.image_size[0]
        x, y, z = self._get_world_coor_from_image(u, v)
        y += 0.01
        dx, dy, dz = action[2:]
        st_high = np.array([x, 0.2, z, 0.0])
        st = np.array([x, y, z, 0.0])
        en = st + np.array([dx, dy, dz, 1.0])
        model_actions = []
        for tgt in (st_high, st, en):
            acts, curr_pos = super().get_model_action(tgt, curr_pos)
            model_actions.extend(acts)
        return model_actions, curr_pos
