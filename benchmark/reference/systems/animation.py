"""Animation system: keyframe tracks evaluated in the step.

Port of `garden_tpu.systems.animation`. Tracks are fixed-capacity device
arrays: each track animates one entity's transform with up to KF keyframes
(position lerp, rotation slerp, scale lerp). `.anim` JSON assets load via
`load_animation`; tracks may carry a stable name that scenes serialize.

Arbitrary component properties: `add_property_keyframes(track, component,
field, keyframes)` attaches a property curve to a track. Device layout is
one table per animated (component, field) pair, and a (tracks,) row map
binds each track to its curve in that table (-1 = the track does not
animate it); each property group is one dense pass. Bool fields take
value > 0.5, int fields the value rounded half to even.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from benchmark.reference.core import math3d as m3
from benchmark.reference.core.ecs import ComponentDef, Field, System, World, to_device

ANIMATION = ComponentDef(
    "animation",
    {
        "track": Field((), np.int32, -1),
        "time": Field((), np.float32, 0.0),
        "playing": Field((), np.bool_, True),
        "looped": Field((), np.bool_, True),
        "speed": Field((), np.float32, 1.0),
    },
)


class AnimationSystem(System):
    component = ANIMATION

    def __init__(self, max_tracks: int = 64, max_keyframes: int = 32):
        self.max_tracks = max_tracks
        self.max_keyframes = max_keyframes
        kf = max_keyframes
        self._times = np.zeros((max_tracks, kf), np.float32)
        self._pos = np.zeros((max_tracks, kf, 3), np.float32)
        self._rot = np.tile(np.array([0, 0, 0, 1], np.float32),
                            (max_tracks, kf, 1))
        self._scale = np.ones((max_tracks, kf, 3), np.float32)
        self._kf_count = np.zeros((max_tracks,), np.int32)
        self._animate_mask = np.zeros((max_tracks, 3), bool)  # pos/rot/scale
        self._count = 0
        # generic property curves: {(component, field): {"times": (P, KF),
        #  "values": (P, KF, *shape), "mode": (P,), "map": {track: row}}}
        self._props: Dict[tuple, Dict[str, Any]] = {}
        # stable asset identity: scenes serialize track *names* (the
        # reference serializes animation asset paths, resource.hpp:485),
        # never raw indices into this process's track arrays
        self._name_to_track: Dict[str, int] = {}
        self._track_to_name: Dict[int, str] = {}

    def attach(self, world: World) -> None:
        super().attach(world)
        world.events.subscribe("Update", self.update, priority=-10.0)

    # -- host-side track building ---------------------------------------------

    def add_track(self, keyframes, name: Optional[str] = None) -> int:
        """keyframes: list of dicts {time, position?, rotation?, scale?}.
        `name` registers a stable identity used by scene serialization."""
        if name is not None and name in self._name_to_track:
            return self._name_to_track[name]
        if self._count >= self.max_tracks:
            raise RuntimeError("track capacity exhausted")
        t = self._count
        self._count += 1
        n = min(len(keyframes), self.max_keyframes)
        self._kf_count[t] = n
        has_p = has_r = has_s = False
        for i, kf in enumerate(keyframes[:n]):
            self._times[t, i] = kf["time"]
            if "position" in kf:
                self._pos[t, i] = kf["position"]
                has_p = True
            elif i > 0:
                self._pos[t, i] = self._pos[t, i - 1]
            if "rotation" in kf:
                self._rot[t, i] = kf["rotation"]
                has_r = True
            elif i > 0:
                self._rot[t, i] = self._rot[t, i - 1]
            if "scale" in kf:
                self._scale[t, i] = kf["scale"]
                has_s = True
            elif i > 0:
                self._scale[t, i] = self._scale[t, i - 1]
        self._animate_mask[t] = (has_p, has_r, has_s)
        # pad tail with the last keyframe so searchsorted clamps cleanly
        for i in range(n, self.max_keyframes):
            self._times[t, i] = self._times[t, n - 1] + 1e6
            self._pos[t, i] = self._pos[t, n - 1]
            self._rot[t, i] = self._rot[t, n - 1]
            self._scale[t, i] = self._scale[t, n - 1]
        if name is not None:
            self._name_to_track[name] = t
            self._track_to_name[t] = name
        return t

    def load_animation(self, path: str) -> int:
        """Load a `.anim` JSON keyframe file (resource.hpp:485 format:
        a list of keyframe objects per transform property). The path is the
        track's stable identity; loading the same path twice dedups."""
        if path in self._name_to_track:
            return self._name_to_track[path]
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        return self.add_track(
            data["keyframes"] if "keyframes" in data else data, name=path)

    def add_property_keyframes(self, track: int, component: str, field: str,
                               keyframes, mode: str = "lerp") -> None:
        """Attach a keyframe curve for any component field to `track`
        (animate.hpp: Animation keyframes arbitrary registered component
        properties). keyframes: list of {time, value}; value shape must
        match the field's per-entity shape (scalar or small vector).
        mode: "lerp" | "step" | "slerp" (slerp requires a 4-vector)."""
        if not keyframes:
            raise ValueError("empty keyframe list")
        if mode not in ("lerp", "step", "slerp"):
            raise ValueError(f"unknown interpolation mode {mode!r}")
        value0 = np.asarray(keyframes[0]["value"], np.float32)
        if mode == "slerp" and value0.shape != (4,):
            raise ValueError("slerp animates quaternion (4,) fields")
        key = (component, field)
        kf = self.max_keyframes
        group = self._props.get(key)
        if group is None:
            group = {
                "times": np.zeros((0, kf), np.float32),
                "values": np.zeros((0, kf) + value0.shape, np.float32),
                "mode": np.zeros((0,), np.int32),
                "durations": np.zeros((0,), np.float32),
                "map": {},
            }
            self._props[key] = group
        if group["values"].shape[2:] != value0.shape:
            raise ValueError(
                f"value shape {value0.shape} != existing "
                f"{group['values'].shape[2:]} for {component}.{field}")
        if track in group["map"]:
            raise ValueError(f"track {track} already animates "
                             f"{component}.{field}")
        n = min(len(keyframes), kf)
        times = np.zeros((kf,), np.float32)
        values = np.zeros((kf,) + value0.shape, np.float32)
        for i, frame in enumerate(keyframes[:n]):
            times[i] = frame["time"]
            values[i] = np.asarray(frame["value"], np.float32)
        for i in range(n, kf):       # pad tail (clamps the searchsorted)
            times[i] = times[n - 1] + 1e6
            values[i] = values[n - 1]
        group["map"][track] = group["times"].shape[0]
        group["times"] = np.concatenate([group["times"], times[None]])
        group["values"] = np.concatenate([group["values"], values[None]])
        group["mode"] = np.concatenate(
            [group["mode"],
             np.array([("lerp", "step", "slerp").index(mode)], np.int32)])
        group["durations"] = np.concatenate(
            [group["durations"], np.array([times[n - 1]], np.float32)])

    def track_name(self, track: int) -> Optional[str]:
        return self._track_to_name.get(track)

    def find_track(self, name: str) -> Optional[int]:
        """Resolve a serialized track identity; loads `.anim` files on
        demand so scenes restore in a fresh process."""
        t = self._name_to_track.get(name)
        if t is None and name.endswith(".anim"):
            import os
            if os.path.exists(name):
                t = self.load_animation(name)
        return t

    def device_state(self) -> Dict[str, Any]:
        dev = self.world.device
        t = lambda a: to_device(a, dev)
        props = {}
        for (component, field), g in self._props.items():
            row_map = np.full((self.max_tracks,), -1, np.int32)
            for track, row in g["map"].items():
                row_map[track] = row
            props[f"{component}.{field}"] = {
                "times": t(g["times"]),
                "values": t(g["values"]),
                "mode": t(g["mode"]),
                "durations": t(g["durations"]),
                "row_map": t(row_map),
            }
        return {
            "times": t(self._times),
            "pos": t(self._pos),
            "rot": t(self._rot),
            "scale": t(self._scale),
            "kf_count": t(self._kf_count),
            "animate_mask": t(self._animate_mask),
            "props": props,
        }

    # -- evaluation ----------------------------------------------------------------

    def update(self, state: Dict[str, Any], ctx: Dict[str, Any]) -> Dict[str, Any]:
        comp = state["components"].get("animation")
        tracks = state.get("animation_tracks")
        if comp is None or tracks is None or "transform" not in state["components"]:
            return state

        dt = ctx["delta_time"]
        track = torch.clamp(comp["track"], min=0).long()
        active = comp["has"] & comp["playing"] & (comp["track"] >= 0)

        last_i = torch.clamp(tracks["kf_count"][track] - 1, min=0)
        times = tracks["times"][track]                       # (E, KF)
        duration = _take_kf(times, last_i)
        props = tracks.get("props", {})
        zero = torch.zeros_like(duration)
        for gdev in props.values():
            # a property-only track still needs a loop duration
            prow = gdev["row_map"][track]
            pdur = torch.where(prow >= 0,
                               gdev["durations"][torch.clamp(prow, min=0).long()], zero)
            duration = torch.maximum(duration, pdur)
        t = comp["time"] + dt * comp["speed"] * active
        t = torch.where(comp["looped"] & (duration > 0),
                        torch.remainder(t, torch.clamp(duration, min=1e-6)),
                        torch.minimum(t, duration))

        hi = _segment(times, t, self.max_keyframes)
        lo = hi - 1
        t_lo = _take_kf(times, lo)
        t_hi = _take_kf(times, hi)
        alpha = torch.clamp((t - t_lo) / torch.clamp(t_hi - t_lo, min=1e-6), 0.0, 1.0)

        key = lambda name, i: _take_kf(tracks[name][track], i)
        pos = m3.lerp(key("pos", lo), key("pos", hi), alpha[:, None])
        # quat_slerp takes t with shape (E,) (it appends the component axis)
        rot = m3.quat_slerp(key("rot", lo), key("rot", hi), alpha)
        scale = m3.lerp(key("scale", lo), key("scale", hi), alpha[:, None])

        mask = tracks["animate_mask"][track]                 # (E, 3)
        tcomp = state["components"]["transform"]
        # shape guards: a silent broadcast here corrupts the store
        for name, got in (("position", pos), ("rotation", rot), ("scale", scale)):
            if got.shape != tcomp[name].shape:
                raise ValueError(f"animation {name} {tuple(got.shape)} != transform "
                                 f"{tuple(tcomp[name].shape)}")
        an_p = active & mask[:, 0] & tcomp["has"]
        an_r = active & mask[:, 1] & tcomp["has"]
        an_s = active & mask[:, 2] & tcomp["has"]
        tcomp = dict(
            tcomp,
            position=torch.where(an_p[:, None], pos, tcomp["position"]),
            rotation=torch.where(an_r[:, None], rot, tcomp["rotation"]),
            scale=torch.where(an_s[:, None], scale, tcomp["scale"]),
        )
        comp = dict(comp, time=torch.where(active, t, comp["time"]))
        components = dict(state["components"], transform=tcomp, animation=comp)

        # generic property curves: one vectorized pass per animated
        # (component, field)
        for gkey, gdev in props.items():
            comp_name, field = gkey.split(".", 1)
            target = components.get(comp_name)
            if target is None or field not in target:
                continue
            prow = gdev["row_map"][track]               # (E,)
            p_active = active & (prow >= 0) & target["has"]
            row = torch.clamp(prow, min=0).long()
            ptimes = gdev["times"][row]                 # (E, KF)
            phi = _segment(ptimes, t, self.max_keyframes)
            plo = phi - 1
            pt_lo = _take_kf(ptimes, plo)
            pt_hi = _take_kf(ptimes, phi)
            palpha = torch.clamp(
                (t - pt_lo) / torch.clamp(pt_hi - pt_lo, min=1e-6), 0.0, 1.0)
            vals = gdev["values"][row]                  # (E, KF, *s)
            v_lo = _take_kf(vals, plo)
            v_hi = _take_kf(vals, phi)
            pa = palpha.reshape(palpha.shape + (1,) * (v_lo.ndim - 1))
            pmode = gdev["mode"][row].reshape(pa.shape)
            value = torch.where(pmode == 1, v_lo,          # step
                                v_lo + (v_hi - v_lo) * pa)  # lerp
            if v_lo.ndim == 2 and v_lo.shape[-1] == 4:
                value = torch.where(pmode == 2, m3.quat_slerp(v_lo, v_hi, palpha), value)
            cur = target[field]
            value = value.reshape(cur.shape)
            if cur.dtype == torch.bool:
                value = value > 0.5
            elif not cur.is_floating_point():
                value = torch.round(value).to(cur.dtype)
            else:
                value = value.to(cur.dtype)
            pa_mask = p_active.reshape(p_active.shape + (1,) * (cur.ndim - 1))
            components[comp_name] = dict(
                target, **{field: torch.where(pa_mask, value, cur)})

        return dict(state, components=components)


def _take_kf(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[e, idx[e]] for arr (E, KF, *s) -> (E, *s)."""
    shape = (arr.shape[0], 1) + tuple(arr.shape[2:])
    i = idx.long().reshape((-1, 1) + (1,) * (arr.ndim - 2)).expand(shape)
    return torch.gather(arr, 1, i)[:, 0]


def _segment(times: torch.Tensor, t: torch.Tensor, kf: int) -> torch.Tensor:
    """The keyframe ending each entity's segment: the count of keys at or
    before t, clamped to [1, kf - 1]."""
    return torch.clamp((times <= t[:, None]).sum(1, dtype=torch.int32), 1, kf - 1)
