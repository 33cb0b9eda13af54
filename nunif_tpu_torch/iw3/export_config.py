"""iw3 export / import configuration, ``iw3_export.yml`` (counterpart of
``nunif_tpu/iw3/export_config.py``, a copy: the port imports nothing of the
JAX package).

``--export`` writes ``rgb/`` and 16-bit ``depth/`` PNG folders and this
file; a later run given the file re-renders from them without the depth
model.  The YAML is flat ``key: value`` lines, written and read by the
small serializer below (no YAML package).
"""
from __future__ import annotations

import os
from fractions import Fraction

FILENAME = "iw3_export.yml"
RGB_DIR = "rgb"
DEPTH_DIR = "depth"
IMAGE_TYPE = "images"
VIDEO_TYPE = "video"


def _dump_yaml(d: dict) -> str:
    lines = []
    for k, v in d.items():
        if v is None:
            continue
        if isinstance(v, bool):
            v = "true" if v else "false"
        lines.append(f"{k}: {v}")
    return "\n".join(lines) + "\n"


def _parse_yaml(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or ":" not in line:
            continue
        k, _, v = line.partition(":")
        v = v.strip()
        if v in ("true", "false"):
            v = v == "true"
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        out[k.strip()] = v
    return out


class ExportConfig:
    def __init__(self, type, basename=None, fps=None, mapper=None,
                 skip_mapper=False, skip_edge_dilation=False,
                 rgb_dir=RGB_DIR, depth_dir=DEPTH_DIR,
                 divergence=None, convergence=None, updated_at=None):
        if type not in (IMAGE_TYPE, VIDEO_TYPE):
            raise ValueError(f"export type {type!r}")
        self.type = type
        self.basename = basename
        self.fps = fps
        self.mapper = mapper
        self.skip_mapper = skip_mapper
        self.skip_edge_dilation = skip_edge_dilation
        self.rgb_dir = rgb_dir
        self.depth_dir = depth_dir
        self.divergence = divergence
        self.convergence = convergence
        self.updated_at = updated_at

    def save(self, file_path: str):
        fps = self.fps
        if isinstance(fps, Fraction):
            fps = (fps.numerator if fps.denominator == 1
                   else f"{fps.numerator}/{fps.denominator}")
        cfg = {
            "type": self.type, "basename": self.basename, "fps": fps,
            "mapper": self.mapper, "skip_mapper": self.skip_mapper,
            "skip_edge_dilation": self.skip_edge_dilation,
            "rgb_dir": self.rgb_dir, "depth_dir": self.depth_dir,
            "divergence": self.divergence, "convergence": self.convergence,
            "updated_at": self.updated_at,
        }
        with open(file_path, "w") as f:
            f.write(_dump_yaml(cfg))

    @classmethod
    def load(cls, file_path: str) -> "ExportConfig":
        with open(file_path) as f:
            cfg = _parse_yaml(f.read())
        fps = cfg.get("fps")
        if isinstance(fps, str) and "/" in fps:
            n, d = fps.split("/")
            fps = Fraction(int(n), int(d))
        return cls(
            type=cfg.get("type", IMAGE_TYPE), basename=cfg.get("basename"),
            fps=fps, mapper=cfg.get("mapper"),
            skip_mapper=bool(cfg.get("skip_mapper", False)),
            skip_edge_dilation=bool(cfg.get("skip_edge_dilation", False)),
            rgb_dir=cfg.get("rgb_dir", RGB_DIR),
            depth_dir=cfg.get("depth_dir", DEPTH_DIR),
            divergence=cfg.get("divergence"),
            convergence=cfg.get("convergence"),
            updated_at=cfg.get("updated_at"))

    def resolve_paths(self, base_dir: str):
        return (os.path.join(base_dir, self.rgb_dir),
                os.path.join(base_dir, self.depth_dir))
