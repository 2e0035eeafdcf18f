"""Scene load/store in the reference's `.scene` JSON format.

Rebuild of ResourceSystem's scene pipeline (include/garden/system/resource.
hpp:463-476 loadScene/storeScene/clearScene; format written by
source/system/resource.cpp:2357,2559-2700): a top-level `entities` array,
each entity a `{"components": [{".type": <name>, ...fields}]}` list;
transforms carry a `uid` string and reference parents by uid; physics
constraints and links resolve uids in a post-deserialize pass
(physics.hpp:777-782). Scenes double as the engine's checkpoints
(SURVEY.md section 5.4).

Systems participate by registering (serialize, deserialize) hooks per
component name — the ISerializable analog. Built-in hooks cover transform,
camera and rigidbody components.

A copy of `garden_tpu.scene.scene` over the port's host-side stores: the
ECS `World`'s numpy staging arrays, `LinkSystem`, and the physics system's
`PhysicsWorld._b` body arrays and `ShapeTable`, which keep the reference's
field names. The `.scene` JSON and BSON are byte for byte the reference's.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from garden_tpu_torch.core.ecs import World
from garden_tpu_torch.systems.link import LinkSystem

SerializeFn = Callable[[World, int], Optional[Dict[str, Any]]]
DeserializeFn = Callable[[World, int, Dict[str, Any], "SceneContext"], None]


class SceneContext:
    """Deserialization context: uid -> entity map + post-resolve hooks."""

    def __init__(self) -> None:
        self.uid_to_entity: Dict[str, int] = {}
        self.post_hooks: List[Callable[[], None]] = []


class SceneSerializer:
    """Registry of per-component serialize/deserialize hooks."""

    def __init__(self, world: World) -> None:
        self.world = world
        self._hooks: Dict[str, Tuple[SerializeFn, DeserializeFn]] = {}
        self._register_builtins()

    def register(self, component: str, serialize: SerializeFn,
                 deserialize: DeserializeFn) -> None:
        self._hooks[component] = (serialize, deserialize)

    # -- store ---------------------------------------------------------------

    def store_scene(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Serialize all alive entities; returns (and optionally writes) the
        scene dict in the reference JSON shape."""
        world = self.world
        link: Optional[LinkSystem] = world.systems.get("LinkSystem")  # type: ignore
        entities = []
        tstore = world._stores.get("transform")
        for e in range(world.capacity):
            if not world._alive[e]:
                continue
            if tstore is not None and tstore["has"][e] and tstore["do_not_serialize"][e]:
                continue
            comps = []
            for name, (ser, _de) in self._hooks.items():
                if name in world._stores and not world._stores[name]["has"][e]:
                    continue
                data = ser(world, e)
                if data is not None:
                    comps.append({".type": name, **data})
            if comps:
                entities.append({"components": comps})
        scene = {"entities": entities}
        if path:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(scene, f, indent=1)
        return scene

    # -- load ----------------------------------------------------------------

    def load_scene(self, source) -> List[int]:
        """Load a scene dict / JSON file / packed BSON file (the shipping
        format, json-serialize.hpp:92-108); returns created entity ids."""
        if isinstance(source, str):
            if source.endswith(".bson"):
                from garden_tpu_torch.assets import bson
                with open(source, "rb") as f:
                    scene = bson.loads(f.read())
            else:
                with open(source, "r", encoding="utf-8") as f:
                    scene = json.load(f)
        else:
            scene = source
        world = self.world
        ctx = SceneContext()
        created: List[int] = []
        pending: List[Tuple[int, str, Dict[str, Any]]] = []

        # pass 1: create entities, collect uids
        for edata in scene.get("entities", []):
            e = world.create_entity()
            created.append(e)
            for comp in edata.get("components", []):
                name = comp[".type"]
                uid = comp.get("uid")
                if uid:
                    ctx.uid_to_entity[uid] = e
                pending.append((e, name, comp))

        # pass 2: deserialize components
        for e, name, comp in pending:
            hook = self._hooks.get(name)
            if hook is None:
                continue
            hook[1](world, e, comp, ctx)

        # pass 3: cross-reference resolution (physics.hpp:777-782 analog)
        for fn in ctx.post_hooks:
            fn()
        return created

    def clear_scene(self) -> None:
        """Destroy all entities except DoNotDestroy (resource.cpp:2533)."""
        world = self.world
        tstore = world._stores.get("transform")
        link: Optional[LinkSystem] = world.systems.get("LinkSystem")  # type: ignore
        for e in range(world.capacity):
            if not world._alive[e]:
                continue
            if tstore is not None and tstore["has"][e] and tstore["do_not_destroy"][e]:
                continue
            if link is not None:
                link.remove(e)
            world.destroy_entity(e)

    # -- built-in component hooks ---------------------------------------------

    def _register_builtins(self) -> None:
        world = self.world

        def ser_transform(w: World, e: int) -> Optional[Dict[str, Any]]:
            s = w._stores.get("transform")
            if s is None or not s["has"][e]:
                return None
            link: Optional[LinkSystem] = w.systems.get("LinkSystem")  # type: ignore
            out: Dict[str, Any] = {}
            if link is not None:
                out["uid"] = link.uuid_of(e) or link.add_link(e)
            out["position"] = [float(v) for v in s["position"][e]]
            out["rotation"] = [float(v) for v in s["rotation"][e]]
            out["scale"] = [float(v) for v in s["scale"][e]]
            if not s["active"][e]:
                out["isActive"] = False
            parent = int(s["parent"][e])
            if parent >= 0 and link is not None:
                out["parent"] = link.uuid_of(parent) or link.add_link(parent)
            return out

        def de_transform(w: World, e: int, d: Dict[str, Any], ctx: SceneContext) -> None:
            w.add_component(
                e, "transform",
                position=d.get("position", [0, 0, 0]),
                rotation=d.get("rotation", [0, 0, 0, 1]),
                scale=d.get("scale", [1, 1, 1]),
                active=d.get("isActive", True),
            )
            link: Optional[LinkSystem] = w.systems.get("LinkSystem")  # type: ignore
            if d.get("uid") and link is not None:
                link.add_link(e, d["uid"])
            parent_uid = d.get("parent")
            if parent_uid:
                def resolve(e=e, parent_uid=parent_uid):
                    p = ctx.uid_to_entity.get(parent_uid)
                    if p is None and link is not None:
                        p = link.find_by_uuid(parent_uid)
                    if p is not None:
                        w.set_component(e, "transform", parent=p)
                ctx.post_hooks.append(resolve)

        self.register("transform", ser_transform, de_transform)

        def ser_camera(w: World, e: int) -> Optional[Dict[str, Any]]:
            s = w._stores.get("camera")
            if s is None or not s["has"][e]:
                return None
            if int(s["proj_type"][e]) == 0:
                return {
                    "projection": "perspective",
                    "fieldOfView": float(s["fov_y"][e]),
                    "aspectRatio": float(s["aspect"][e]),
                    "nearPlane": float(s["near"][e]),
                }
            return {
                "projection": "orthographic",
                "extents": [float(v) for v in s["ortho_extents"][e]],
            }

        def de_camera(w: World, e: int, d: Dict[str, Any], ctx: SceneContext) -> None:
            if d.get("projection", "perspective") == "perspective":
                w.add_component(e, "camera", proj_type=0,
                                fov_y=d.get("fieldOfView", 0.9),
                                aspect=d.get("aspectRatio", 16 / 9),
                                near=d.get("nearPlane", 0.1))
            else:
                w.add_component(e, "camera", proj_type=1,
                                ortho_extents=d.get("extents",
                                                    [-1, 1, -1, 1, -1, 1]))

        self.register("camera", ser_camera, de_camera)

        def ser_rigidbody(w: World, e: int) -> Optional[Dict[str, Any]]:
            s = w._stores.get("rigidbody")
            if s is None or not s["has"][e]:
                return None
            phys = w.systems.get("PhysicsSystem")
            if phys is None:
                return None
            b = int(s["body"][e])
            bd = phys.physics._b
            shapes = phys.physics.shapes
            shape_idx = int(bd["shape"][b])
            stype = int(shapes.types[shape_idx])
            params = shapes.params[shape_idx]
            from garden_tpu_torch.physics import shapes as sh
            shape_data: Dict[str, Any] = {"shapeType": sh.SHAPE_NAMES[stype]}
            if stype == sh.SPHERE:
                shape_data["radius"] = float(params[0])
            elif stype == sh.BOX:
                shape_data["halfExtent"] = [float(v) for v in params[:3]]
                shape_data["convexRadius"] = float(params[3])
            elif stype == sh.CAPSULE:
                shape_data["radius"] = float(params[0])
                shape_data["halfHeight"] = float(params[1])
            elif stype == sh.PLANE:
                shape_data["normal"] = [float(v) for v in params[:3]]
                shape_data["distance"] = float(params[3])
            elif stype == sh.HULL:
                h = int(params[0])
                nv = int(shapes.hull_vert_valid[h].sum())
                shape_data["points"] = [
                    [float(v) for v in p] for p in shapes.hull_verts[h, :nv]]
                shape_data["convexRadius"] = float(params[1])
            elif stype == sh.HEIGHTFIELD:
                f, cell = int(params[0]), float(params[1])
                nx, nz = int(params[2]), int(params[3])
                shape_data["cellSize"] = cell
                shape_data["heights"] = [
                    [float(v) for v in row]
                    for row in shapes.hf_heights[f, :nz, :nx]]
            elif stype == sh.COMPOUND:
                c = int(params[0])
                kids = []
                for k in range(sh.MAX_CHILDREN):
                    ct = int(shapes.comp_type[c, k])
                    if ct == sh.EMPTY:
                        continue
                    cp = shapes.comp_params[c, k]
                    kid: Dict[str, Any] = {
                        "shapeType": sh.SHAPE_NAMES[ct],
                        "position": [float(v) for v in shapes.comp_pos[c, k]],
                        "rotation": [float(v) for v in shapes.comp_quat[c, k]],
                    }
                    if ct == sh.SPHERE:
                        kid["radius"] = float(cp[0])
                    elif ct == sh.BOX:
                        kid["halfExtent"] = [float(v) for v in cp[:3]]
                    else:
                        kid["radius"] = float(cp[0])
                        kid["halfHeight"] = float(cp[1])
                    kids.append(kid)
                shape_data["children"] = kids
            return {
                **shape_data,
                "motionType": ["static", "kinematic", "dynamic"][int(bd["motion"][b])],
                "linearVelocity": [float(v) for v in bd["linvel"][b]],
                "angularVelocity": [float(v) for v in bd["angvel"][b]],
                "friction": float(bd["friction"][b]),
                "restitution": float(bd["restitution"][b]),
                "isSensor": bool(bd["is_sensor"][b]),
            }

        def de_rigidbody(w: World, e: int, d: Dict[str, Any], ctx: SceneContext) -> None:
            phys = w.systems.get("PhysicsSystem")
            if phys is None:
                return
            from garden_tpu_torch.physics import shapes as sh
            from garden_tpu_torch.physics import world as pw
            st = d.get("shapeType", "box")
            shapes = phys.physics.shapes
            if st == "sphere":
                shape = shapes.sphere(d.get("radius", 0.5))
            elif st == "capsule":
                shape = shapes.capsule(d.get("radius", 0.3), d.get("halfHeight", 0.5))
            elif st == "plane":
                shape = shapes.plane(tuple(d.get("normal", (0, 1, 0))),
                                     d.get("distance", 0.0))
            elif st == "hull":
                import numpy as _np
                shape = shapes.hull(_np.asarray(d["points"], _np.float32),
                                    d.get("convexRadius", 0.05))
            elif st == "heightfield":
                import numpy as _np
                shape = shapes.heightfield(
                    _np.asarray(d["heights"], _np.float32),
                    d.get("cellSize", 1.0))
            elif st == "compound":
                kids = []
                for kid in d.get("children", []):
                    kt = kid.get("shapeType", "box")
                    if kt == "sphere":
                        ks = shapes.sphere(kid.get("radius", 0.5))
                    elif kt == "capsule":
                        ks = shapes.capsule(kid.get("radius", 0.3),
                                            kid.get("halfHeight", 0.5))
                    else:
                        ks = shapes.box(tuple(kid.get("halfExtent",
                                                      (0.5, 0.5, 0.5))))
                    kids.append((ks, tuple(kid.get("position", (0, 0, 0))),
                                 tuple(kid.get("rotation", (0, 0, 0, 1)))))
                shape = shapes.compound(kids)
            else:
                shape = shapes.box(tuple(d.get("halfExtent", (0.5, 0.5, 0.5))),
                                   d.get("convexRadius", 0.05))
            motion = {"static": 0, "kinematic": 1, "dynamic": 2}[
                d.get("motionType", "dynamic")]
            phys.add_rigidbody(
                e, shape, motion=motion,
                linvel=tuple(d.get("linearVelocity", (0, 0, 0))),
                angvel=tuple(d.get("angularVelocity", (0, 0, 0))),
                friction=d.get("friction", 0.5),
                restitution=d.get("restitution", 0.0),
                is_sensor=d.get("isSensor", False),
            )

        self.register("rigidbody", ser_rigidbody, de_rigidbody)

        # -- simple field-mapped components (animation/spawner/character/ui) --

        def make_simple(name: str, fields: Dict[str, str],
                        adder=None):
            """Register a component whose fields map 1:1 to scene keys."""

            def ser(w: World, e: int) -> Optional[Dict[str, Any]]:
                s = w._stores.get(name)
                if s is None or not s["has"][e]:
                    return None
                out = {}
                for field, key in fields.items():
                    v = s[field][e]
                    arr = np.asarray(v)
                    out[key] = arr.tolist() if arr.ndim else arr.item()
                return out

            def de(w: World, e: int, d: Dict[str, Any], ctx: SceneContext) -> None:
                if name not in w._stores:
                    return
                kwargs = {f: d[k] for f, k in fields.items() if k in d}
                w.add_component(e, name, **kwargs)

            self.register(name, ser, de)

        # animation: the track field is an index into AnimationSystem's
        # in-process arrays — serialize the track's stable asset name instead
        # (the reference serializes animation paths, resource.hpp:485)
        def ser_animation(w: World, e: int) -> Optional[Dict[str, Any]]:
            s = w._stores.get("animation")
            if s is None or not s["has"][e]:
                return None
            out: Dict[str, Any] = {
                "time": float(s["time"][e]),
                "isPlaying": bool(s["playing"][e]),
                "isLooped": bool(s["looped"][e]),
                "speed": float(s["speed"][e]),
            }
            anim = w.systems.get("AnimationSystem")
            track = int(s["track"][e])
            if anim is not None and track >= 0:
                name = anim.track_name(track)
                if name is not None:
                    out["animation"] = name
            return out

        def de_animation(w: World, e: int, d: Dict[str, Any],
                         ctx: SceneContext) -> None:
            if "animation" not in w._stores:
                return
            anim = w.systems.get("AnimationSystem")
            track = -1
            if anim is not None and "animation" in d:
                t = anim.find_track(d["animation"])
                if t is not None:
                    track = t
            w.add_component(e, "animation", track=track,
                            time=d.get("time", 0.0),
                            playing=d.get("isPlaying", True),
                            looped=d.get("isLooped", True),
                            speed=d.get("speed", 1.0))

        self.register("animation", ser_animation, de_animation)

        # spawner: include the prefab binding (spawner.hpp's path field);
        # the factory itself must be registered by the app before load
        def ser_spawner(w: World, e: int) -> Optional[Dict[str, Any]]:
            s = w._stores.get("spawner")
            if s is None or not s["has"][e]:
                return None
            out: Dict[str, Any] = {
                "mode": int(s["mode"][e]), "delay": float(s["delay"][e]),
                "maxCount": int(s["max_count"][e]),
                "isActive": bool(s["is_active"][e]),
            }
            sp = w.systems.get("SpawnerSystem")
            if sp is not None and e in sp._spawner_prefab:
                out["path"] = sp._spawner_prefab[e]
            return out

        def de_spawner(w: World, e: int, d: Dict[str, Any],
                       ctx: SceneContext) -> None:
            if "spawner" not in w._stores:
                return
            w.add_component(e, "spawner", mode=d.get("mode", 0),
                            delay=d.get("delay", 0.0),
                            max_count=d.get("maxCount", 1),
                            is_active=d.get("isActive", True))
            sp = w.systems.get("SpawnerSystem")
            if sp is not None and "path" in d:
                sp._spawner_prefab[e] = d["path"]

        self.register("spawner", ser_spawner, de_spawner)
        make_simple("character", {
            "max_slope_cos": "maxSlopeCos", "control_accel": "controlAccel",
        })
        make_simple("ui_transform", {
            "position": "position", "size": "size", "anchor": "anchor",
            "visible": "isVisible",
        })
        make_simple("ui_button", {"enabled": "isEnabled"})
        make_simple("ui_checkbox", {"checked": "isChecked"})
        make_simple("ui_scissor", {"enabled": "isEnabled"})
        make_simple("ui_trigger", {"enabled": "isEnabled"})

        # label/input carry host-side text (stable content, like spawner
        # prefab paths) plus their device fields
        def ser_ui_label(w: World, e: int) -> Optional[Dict[str, Any]]:
            s = w._stores.get("ui_label")
            if s is None or not s["has"][e]:
                return None
            sys_ = w.systems.get("UiLabelSystem")
            return {
                "text": sys_.text(e) if sys_ else "",
                "color": [float(v) for v in s["color"][e]],
                "scale": float(s["scale"][e]),
            }

        def de_ui_label(w: World, e: int, d: Dict[str, Any],
                        ctx: SceneContext) -> None:
            w.add_component(e, "ui_label", color=d.get("color", [1, 1, 1, 1]),
                            scale=d.get("scale", 1.0))
            sys_ = w.systems.get("UiLabelSystem")
            if sys_ is not None:
                sys_.set_text(e, d.get("text", ""))

        self.register("ui_label", ser_ui_label, de_ui_label)

        def ser_ui_input(w: World, e: int) -> Optional[Dict[str, Any]]:
            s = w._stores.get("ui_input")
            if s is None or not s["has"][e]:
                return None
            sys_ = w.systems.get("UiInputSystem")
            return {
                "text": sys_.text(e) if sys_ else "",
                "maxLength": int(s["max_length"][e]),
                "isEnabled": bool(s["enabled"][e]),
            }

        def de_ui_input(w: World, e: int, d: Dict[str, Any],
                        ctx: SceneContext) -> None:
            w.add_component(e, "ui_input",
                            max_length=d.get("maxLength", 64),
                            enabled=d.get("isEnabled", True))
            sys_ = w.systems.get("UiInputSystem")
            if sys_ is not None:
                sys_.set_text(e, d.get("text", ""))

        self.register("ui_input", ser_ui_input, de_ui_input)
        make_simple("network", {
            "client_uid": "clientUID", "entity_uid": "entityUID",
            "is_client_owned": "isClientOwned",
        })
