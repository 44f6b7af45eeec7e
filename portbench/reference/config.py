"""The reference's configuration: the mapper, sensor, gate, EKF and SLAM
settings of the upstream project (exie1122/micro-quad-SLAM,
`uav_local_nav.c`) as the configuration files under portbench/configs/
state them, and the padded-grid geometry derived from the map.

The dataclasses carry the upstream defaults; `load` overrides them with a
configuration file's groups, so the file is the configuration that both
the program and the reference run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MapConfig:
    res_m: float = 0.10
    size_m: float = 50.0
    width: int = 500
    height: int = 500
    lo_free_dec: int = 1
    lo_occ_inc: int = 6
    lo_min: int = -80
    lo_max: int = 80
    lo_miss_end_dec: int = 0
    recenter_frac: float = 0.60
    recenter_max_shift_frac: float = 0.50

    @property
    def recenter_max_shift_cells(self) -> int:
        return int(self.size_m * 0.5 / self.res_m * self.recenter_max_shift_frac)

    @property
    def max_ray_cells(self) -> int:
        return int(round(4.0 / self.res_m))


@dataclass(frozen=True)
class TofConfig:
    max_range_m: float = 4.00
    fov_deg: float = 63.0
    min_valid_m: float = 0.02
    map_skip_below_m: float = 0.05
    hit_margin_m: float = 0.05
    filt_alpha: float = 0.20
    dir_center_deg: tuple = (0.0, 90.0, 180.0, -90.0)


@dataclass(frozen=True)
class GateConfig:
    of_min_quality: int = 50


@dataclass(frozen=True)
class EkfConfig:
    q_pos: float = 1e-4
    q_vel: float = 0.4
    q_vz: float = 0.4
    q_yaw: float = 1e-4
    q_wz: float = 0.5
    r_flow_vel: float = 1e-2
    r_zero_vel: float = 1.0
    r_rf: float = 4e-4
    r_yaw: float = 3e-4
    min_flow_quality: int = 50
    min_ground_m: float = 0.05


@dataclass(frozen=True)
class SlamConfig:
    kf_every: int = 10
    gn_iters: int = 5
    match_n_xy: int = 7
    match_n_yaw: int = 7
    match_xy_step_m: float = 0.05
    match_yaw_step_deg: float = 1.0
    match_min_quality: float = 3.0
    match_chunk_intervals: int = 4
    match_map_kf_only: bool = True
    match_feedback: bool = False
    match_iters: int = 2
    loop_min_gap: int = 3
    loop_r_max_m: float = 1.0
    loop_n_xy: int = 5
    loop_n_yaw: int = 5
    loop_min_quality: float = 0.5
    loop_edges: int = 2
    loop_cand: int = 3
    loop_huber: float = 1.0
    loop_q_ref: float = 1.5
    loop_q_min: float = 1.0
    loop_q_max: float = 1.0
    loop_refine: int = 3
    loop_refine_early: int = -1
    gn_refine_iters: int = 0
    match_iters_later: int = 0
    slam_outer: int = 3
    odo_scale_min: float = 0.8
    odo_scale_max: float = 1.25
    odo_w: tuple = (100.0, 100.0, 400.0)
    anchor_w: tuple = (10.0, 10.0, 40.0)
    loop_w: tuple = (120.0, 120.0, 480.0)
    recenter: bool = True


@dataclass(frozen=True)
class GridGeom:
    width: int = 500
    height: int = 500
    pad: int = 48
    win_r: int = 44
    win_rows: int = 96
    win_cols: int = 128
    prows: int = 608
    pcols: int = 640


@dataclass(frozen=True)
class Config:
    map: MapConfig = field(default_factory=MapConfig)
    tof: TofConfig = field(default_factory=TofConfig)
    gates: GateConfig = field(default_factory=GateConfig)
    ekf: EkfConfig = field(default_factory=EkfConfig)
    slam: SlamConfig = field(default_factory=SlamConfig)
    geom: GridGeom = field(default_factory=GridGeom)


GROUPS = {"map": MapConfig, "tof": TofConfig, "gates": GateConfig,
          "ekf": EkfConfig, "slam": SlamConfig, "geom": GridGeom}


def _group(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown keys {sorted(unknown)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items()})


def load(conf: dict) -> Config:
    """A configuration file's dict -> Config (every group it names
    replaces that group's defaults key by key)."""
    return Config(**{g: _group(cls, conf.get(g, {}))
                     for g, cls in GROUPS.items()})
