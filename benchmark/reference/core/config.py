"""Engine configuration tree (JAX-free mirror of `garden_tpu.core.config`).

The JAX package's config module cannot be imported without JAX (its package
`__init__` pulls in `math3d`), so the port keeps its own copy of the
dataclasses. Field names and defaults must stay equal to the reference;
`tests/test_torch_config.py` checks that they do. Every field is static:
changing one changes which code paths run, as in the reference.
`to_json` / `from_json` persist an `EngineConfig` in the reference's JSON
format, so a config written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Capacities and rates of the physics step."""

    max_bodies: int = 4096
    max_contacts_per_body: int = 16
    # contact slots kept per body after narrowphase compaction
    max_active_contacts: int = 16
    simulation_rate: int = 60           # fixed-step Hz
    collision_steps: int = 1
    solver_iterations: int = 10         # velocity solver iterations
    position_iterations: int = 2
    baumgarte: float = 0.2
    speculative_margin: float = 0.08    # speculative contact distance
    penetration_slop: float = 0.005
    gravity: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    cell_size: float = 2.0              # broadphase uniform-grid cell edge
    grid_dim: int = 64                  # cells per axis
    max_bodies_per_cell: int = 8
    # grid-bypassing big bodies (planes) tested against every body
    max_globals: int = 4
    cascade_lag_threshold: float = 0.5
    sleep_enabled: bool = False


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """Cascaded shadow maps."""

    cascade_count: int = 3
    map_size: int = 2048
    cascade_sizes: Optional[Tuple[int, ...]] = None
    distance: float = 100.0
    split_ratios: Tuple[float, float] = (0.1, 0.25)
    bias_constant: float = 0.0012
    bias_normal: float = 0.05
    pcf_radius: int = 1
    atlas_tile_h: Optional[int] = None
    atlas_foot_y: Optional[int] = None
    max_active_tiles: Optional[int] = None
    resolve_step: int = 1

    def __post_init__(self):
        s = self.resolve_step
        if s < 1 or (s & (s - 1)) != 0:
            raise ValueError(
                f"resolve_step must be a power of two >= 1, got {s}")
        if self.cascade_sizes is not None:
            if len(self.cascade_sizes) != self.cascade_count:
                raise ValueError(
                    f"cascade_sizes has {len(self.cascade_sizes)} entries "
                    f"for {self.cascade_count} cascades")
            if self.cascade_sizes[0] != max(self.cascade_sizes):
                raise ValueError(
                    "cascade_sizes[0] (the near cascade) must be the "
                    "largest — it sets the atlas height")


@dataclasses.dataclass(frozen=True)
class SSRConfig:
    """Screen-space reflections (not ported yet; kept so configs mirror)."""

    trace_step: int = 4
    steps: int = 16
    max_distance: float = 40.0
    first_step: float = 0.02
    thickness: float = 0.08
    max_roughness: float = 0.6

    def __post_init__(self):
        s = self.trace_step
        if s < 1 or (s & (s - 1)) != 0:
            raise ValueError(
                f"trace_step must be a power of two >= 1, got {s}")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Deferred pipeline options."""

    width: int = 1920
    height: int = 1080
    tile_size: int = 128                # raster tile width
    tile_h: Optional[int] = None        # raster tile height (None = square)
    # main-pass binning y-footprint in tiles (None = auto)
    foot_y: Optional[int] = None
    max_triangles: int = 65536
    max_tris_per_tile: int = 512
    max_instances: int = 1024
    max_vertices: int = 65536
    use_shadows: bool = True
    use_hbao: bool = True
    use_bloom: bool = True
    use_auto_exposure: bool = True
    use_fxaa: bool = True
    aa_mode: str = "fxaa"
    use_atmosphere: bool = True
    use_clouds: bool = False
    use_aerial_perspective: bool = True
    aerial_km_per_unit: float = 0.001
    use_oit: bool = True
    use_trans_depth: bool = False
    use_occlusion_culling: bool = False
    render_scale: float = 1.0
    use_velocity: bool = False
    bloom_mip_count: int = 5
    exposure_histogram_bins: int = 256
    tone_mapper: str = "aces"           # "aces" | "uchimura"
    # LdrRender (exposure/tonemap) in bfloat16, as the reference
    post_bf16: bool = True
    exposure_compensation: float = 0.0
    shadow: ShadowConfig = dataclasses.field(default_factory=ShadowConfig)
    use_ssr: bool = False
    ssr: SSRConfig = dataclasses.field(default_factory=SSRConfig)
    use_ssgi: bool = False
    ssgi_intensity: float = 1.0


# quality presets (GraphicsQuality PotatoPC..Ultra)
QUALITY_PRESETS = {
    "potato": dict(use_shadows=False, use_hbao=False, use_bloom=False,
                   use_atmosphere=False, use_fxaa=False, use_oit=False,
                   render_scale=0.5),
    "low": dict(use_hbao=False, use_bloom=False, render_scale=0.75,
                shadow=ShadowConfig(map_size=512, cascade_count=2,
                                    resolve_step=2)),
    "medium": dict(shadow=ShadowConfig(map_size=1024, resolve_step=2)),
    "high": dict(shadow=ShadowConfig(map_size=2048)),
    "ultra": dict(use_clouds=True, use_ssr=True, use_ssgi=True,
                  shadow=ShadowConfig(map_size=2048, pcf_radius=2)),
}

# The pass set of the port's first slice: the "potato" preset's switches at
# full render scale. Everything else keeps the combined step's settings.
SLICE_OVERRIDES = dict(use_shadows=False, use_hbao=False, use_bloom=False,
                       use_atmosphere=False, use_fxaa=False)


def render_quality(quality: str = "medium", **overrides) -> RenderConfig:
    """RenderConfig from a quality preset name."""
    kw = dict(QUALITY_PRESETS[quality])
    kw.update(overrides)
    return RenderConfig(**kw)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    capacity: int = 4096                # entity capacity
    physics: PhysicsConfig = dataclasses.field(default_factory=PhysicsConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    max_tick_rate: int = 60             # the host loop's tick-rate cap
    # leading batch axis for multi-world; carried so configs mirror, batched
    # worlds (parallel/worlds.py) are not ported yet
    world_batch: int = 1


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def _from_dict(cls: type, data: Dict[str, Any]) -> Any:
    # resolve string annotations (PEP 563) to real types
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = hints.get(f.name, f.type)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            v = _from_dict(ftype, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def to_json(cfg: EngineConfig) -> str:
    """The config tree as JSON, in the reference's format: a JSON string
    written by either package loads in the other."""
    return json.dumps(_to_dict(cfg), indent=2)


def from_json(text: str, cls: type = EngineConfig) -> EngineConfig:
    return _from_dict(cls, json.loads(text))
