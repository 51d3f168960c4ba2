"""Non-optimized data payloads attached to vertices: laser scans, tags.

JAX re-design of g2o/types/data (robot_laser.cpp, raw_laser.cpp,
vertex_tag.cpp, data_queue.h). These never touch the device — they are
structured payloads riding along with graph vertices (the reference chains
them via Data::next(), optimizable_graph.h:82-98; here each vertex record
carries a list). The .g2o loader attaches a data line to the most recently
parsed vertex (optimizable_graph.cpp:541-565).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["LaserParameters", "RawLaser", "RobotLaser", "VertexTag",
           "DataQueue", "DATA_TYPES", "parse_data_line", "format_data_line"]


@dataclass
class LaserParameters:
    """Sensor geometry of a laser scanner (types/data/laser_parameters.h)."""
    type: int = 0
    beams: int = 0
    first_beam_angle: float = 0.0
    angular_step: float = 0.0
    max_range: float = 0.0
    accuracy: float = 0.0
    remission_mode: int = 0
    fov: float = 0.0
    laser_pose: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class RawLaser:
    """A raw range scan (types/data/raw_laser.h:46)."""
    tag = "RAWLASER1"
    params: LaserParameters = field(default_factory=LaserParameters)
    ranges: np.ndarray = field(default_factory=lambda: np.zeros(0))
    remissions: np.ndarray = field(default_factory=lambda: np.zeros(0))
    timestamp: float = 0.0
    hostname: str = "hostname"
    logger_timestamp: float = 0.0

    @classmethod
    def parse(cls, toks):
        it = iter(toks)
        nxt = lambda: next(it)
        ltype = int(nxt()); angle = float(nxt()); fov = float(nxt())
        res = float(nxt()); maxrange = float(nxt()); acc = float(nxt())
        rem_mode = int(nxt())
        beams = int(nxt())
        ranges = np.array([float(nxt()) for _ in range(beams)])
        n_rem = int(nxt())
        remissions = np.array([float(nxt()) for _ in range(n_rem)])
        ts = float(nxt()); host = nxt(); lts = float(nxt())
        params = LaserParameters(ltype, beams, angle, res, maxrange, acc,
                                 rem_mode, fov)
        return cls(params=params, ranges=ranges, remissions=remissions,
                   timestamp=ts, hostname=host, logger_timestamp=lts)

    def format(self):
        parts = [f"{self.params.type}", f"{self.params.first_beam_angle!r}",
                 f"{self.params.fov!r}", f"{self.params.angular_step!r}",
                 f"{self.params.max_range!r}", f"{self.params.accuracy!r}",
                 f"{self.params.remission_mode}", f"{len(self.ranges)}"]
        parts += [repr(float(r)) for r in self.ranges]
        parts.append(str(len(self.remissions)))
        parts += [repr(float(r)) for r in self.remissions]
        parts += [repr(float(self.timestamp)), self.hostname,
                  repr(float(self.logger_timestamp))]
        return " ".join(parts)

    def cartesian(self):
        """Beam endpoints in the laser frame [N, 2]."""
        angles = (self.params.first_beam_angle
                  + np.arange(len(self.ranges)) * self.params.angular_step)
        valid = self.ranges < self.params.max_range
        r = np.where(valid, self.ranges, 0.0)
        return np.stack([r * np.cos(angles), r * np.sin(angles)], axis=1)


@dataclass
class RobotLaser(RawLaser):
    """A laser scan + odometry poses at capture time
    (types/data/robot_laser.h:42, read format robot_laser.cpp:50-90)."""
    tag = "ROBOTLASER1"
    laser_pose: np.ndarray = field(default_factory=lambda: np.zeros(3))
    odom_pose: np.ndarray = field(default_factory=lambda: np.zeros(3))
    tv: float = 0.0
    rv: float = 0.0
    forward_safety_dist: float = 0.0
    side_safety_dist: float = 0.0
    turn_axis: float = 0.0

    @classmethod
    def parse(cls, toks):
        it = iter(toks)
        nxt = lambda: next(it)
        ltype = int(nxt()); angle = float(nxt()); fov = float(nxt())
        res = float(nxt()); maxrange = float(nxt()); acc = float(nxt())
        rem_mode = int(nxt())
        beams = int(nxt())
        ranges = np.array([float(nxt()) for _ in range(beams)])
        n_rem = int(nxt())
        remissions = np.array([float(nxt()) for _ in range(n_rem)])
        laser_pose = np.array([float(nxt()) for _ in range(3)])
        odom_pose = np.array([float(nxt()) for _ in range(3)])
        tv = float(nxt()); rv = float(nxt())
        fwd = float(nxt()); side = float(nxt()); turn = float(nxt())
        ts = float(nxt()); host = nxt(); lts = float(nxt())
        params = LaserParameters(ltype, beams, angle, res, maxrange, acc,
                                 rem_mode, fov)
        return cls(params=params, ranges=ranges, remissions=remissions,
                   timestamp=ts, hostname=host, logger_timestamp=lts,
                   laser_pose=laser_pose, odom_pose=odom_pose, tv=tv, rv=rv,
                   forward_safety_dist=fwd, side_safety_dist=side,
                   turn_axis=turn)

    def format(self):
        parts = [f"{self.params.type}", f"{self.params.first_beam_angle!r}",
                 f"{self.params.fov!r}", f"{self.params.angular_step!r}",
                 f"{self.params.max_range!r}", f"{self.params.accuracy!r}",
                 f"{self.params.remission_mode}",
                 f"{len(self.ranges)}"]
        parts += [repr(float(r)) for r in self.ranges]
        parts.append(str(len(self.remissions)))
        parts += [repr(float(r)) for r in self.remissions]
        parts += [repr(float(v)) for v in self.laser_pose]
        parts += [repr(float(v)) for v in self.odom_pose]
        parts += [repr(float(v)) for v in
                  (self.tv, self.rv, self.forward_safety_dist,
                   self.side_safety_dist, self.turn_axis, self.timestamp)]
        parts.append(self.hostname)
        parts.append(repr(float(self.logger_timestamp)))
        return " ".join(parts)


@dataclass
class VertexTag:
    """A named marker attached to a vertex (types/data/vertex_tag.h:42)."""
    tag = "VERTEX_TAG"
    name: str = ""
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    odom_pose: np.ndarray = field(default_factory=lambda: np.zeros(3))
    timestamp: float = 0.0
    hostname: str = "hostname"
    logger_timestamp: float = 0.0

    @classmethod
    def parse(cls, toks):
        name = toks[0]
        vals = [float(t) for t in toks[1:7]]
        ts = float(toks[7]); host = toks[8]; lts = float(toks[9])
        return cls(name=name, position=np.array(vals[:3]),
                   odom_pose=np.array(vals[3:6]), timestamp=ts,
                   hostname=host, logger_timestamp=lts)

    def format(self):
        vals = [*self.position, *self.odom_pose]
        return " ".join([self.name, *[repr(float(v)) for v in vals],
                         repr(float(self.timestamp)), self.hostname,
                         repr(float(self.logger_timestamp))])


class DataQueue:
    """Timestamp-ordered payload queue (types/data/data_queue.h:40)."""

    def __init__(self):
        self._items = []

    def add(self, data):
        self._items.append(data)
        self._items.sort(key=lambda d: d.timestamp)

    def before(self, timestamp):
        best = None
        for d in self._items:
            if d.timestamp <= timestamp:
                best = d
            else:
                break
        return best

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)


DATA_TYPES = {
    "ROBOTLASER1": RobotLaser,
    "RAWLASER1": RawLaser,
    "VERTEX_TAG": VertexTag,
}


def parse_data_line(tag, toks):
    cls = DATA_TYPES.get(tag)
    if cls is None:
        return None
    return cls.parse(toks)


def format_data_line(data):
    return f"{data.tag} {data.format()}"
