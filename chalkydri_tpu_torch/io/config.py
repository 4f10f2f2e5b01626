"""Runtime TOML configuration.

Schema-parity rebuild of the reference's ``chalkydri_core`` config
(``crates/chalkydri_core/src/config.rs:38-207``) and its
near-duplicate ``chalkydri_config`` crate (unified here, as SURVEY.md
section 5.6 recommends): team_number, ntables_ip, rerun, device_name,
cameras[] (id/name/settings/subsystems/calib/exposure/orientation/offsets),
field layout selection + embedded layouts, custom subsystems.

Load order matches the reference's fallback chain /boot -> /etc -> ./
(``crates/chalkydri/src/main.rs:76-87``). A process-wide ``Cfg`` handle
mirrors the reference's global ``RwLock<Config>``
(``chalkydri_core/src/config.rs:14``).
"""

from __future__ import annotations

import threading
import tomllib
from dataclasses import asdict, dataclass, field
from enum import Enum
from typing import Any, Optional

CONFIG_SEARCH_PATHS = (
    "/boot/chalkydri.toml",
    "/etc/chalkydri.toml",
    "./chalkydri.toml",
)


class VideoOrientation(str, Enum):
    """chalkydri_core/src/config.rs:198-207 (kebab-case serde names)."""

    NONE = "none"
    CLOCKWISE = "clockwise"
    ROTATE_180 = "rotate-180"
    COUNTERCLOCKWISE = "counterclockwise"


@dataclass
class CfgFraction:
    num: int = 0
    den: int = 1


@dataclass
class CameraSettings:
    width: int = 0
    height: int = 0
    frame_rate: Optional[CfgFraction] = None
    format: Optional[str] = None


@dataclass
class CameraOffsetDimensions:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclass
class CameraOffsets:
    translation: CameraOffsetDimensions = field(default_factory=CameraOffsetDimensions)
    rotation: CameraOffsetDimensions = field(default_factory=CameraOffsetDimensions)


@dataclass
class MjpegSubsys:
    width: int = 1280
    height: int = 720


@dataclass
class CAprilTagsSubsys:
    max_frame_rate: int = 40  # chalkydri_core/src/config.rs:157
    # Texture-flood recovery: re-run overflowed frames on a 2x-candidate-
    # budget program (runtime/app.py capacity redispatch). Extension key —
    # absent from the reference schema, ignored by it.
    capacity_fallback: bool = False


@dataclass
class MlSubsys:
    """Empty config slot in the reference (config.rs:101-102); here it names
    a torch model hook run on the App's device (SURVEY.md section 2.3:
    the Coral Edge TPU slot becomes inference on the card)."""

    model: Optional[str] = None


@dataclass
class CameraSubsystems:
    mjpeg: Optional[MjpegSubsys] = None
    capriltags: Optional[CAprilTagsSubsys] = None
    ml: Optional[MlSubsys] = None
    custom: list[str] = field(default_factory=list)


@dataclass
class Camera:
    online: bool = False  # skip_deserializing in the reference
    id: str = ""
    name: str = ""
    settings: Optional[CameraSettings] = None
    possible_settings: Optional[list[CameraSettings]] = None
    subsystems: CameraSubsystems = field(
        default_factory=lambda: CameraSubsystems(
            mjpeg=MjpegSubsys(), capriltags=CAprilTagsSubsys()
        )
    )
    calib: Optional[str] = None  # embedded calib JSON string
    auto_exposure: bool = True
    manual_exposure: Optional[int] = None
    orientation: VideoOrientation = VideoOrientation.NONE
    cam_offsets: CameraOffsets = field(default_factory=CameraOffsets)


@dataclass
class Rerun:
    server_address: Optional[str] = None


@dataclass
class MeshCfg:
    """Device-mesh topology for the fused vision programs.

    The reference's scaling surface is graph topology in configuration
    (``chalkydri.ron:1-157`` — chains per camera); the device analogue
    is the device grid, so it is configuration too:

        [mesh]
        data = 4    # camera/frame data-parallel axis
        space = 2   # row-sharding (sequence-parallel) axis for big frames

    ``data * space`` cards are claimed. With ``space > 1`` each frame's
    rows additionally span the 'space' axis end to end (halo and seam
    exchanges between row bands; parallel/pipeline.py). ``data = 1, space = 1`` (default) is
    the single-device program.
    """

    data: int = 1
    space: int = 1


@dataclass
class CustomSubsystem:
    code: str = ""


@dataclass
class Config:
    team_number: int = 0xFFFF  # u16::MAX default (config.rs:130)
    ntables_ip: Optional[str] = None
    rerun: Optional[Rerun] = None
    cameras: Optional[list[Camera]] = None
    device_name: Optional[str] = None
    field_layout: Optional[str] = None
    field_layouts: Optional[dict[str, Any]] = None
    custom_subsystems: dict[str, CustomSubsystem] = field(default_factory=dict)
    mesh: Optional[MeshCfg] = None

    # -- (de)serialization --------------------------------------------------

    @staticmethod
    def from_dict(d: dict) -> "Config":
        def opt(cls, v):
            return None if v is None else cls(**v)

        cameras = None
        if d.get("cameras") is not None:
            cameras = []
            for c in d["cameras"]:
                c = dict(c)
                c.pop("online", None)  # skip_deserializing
                settings = c.pop("settings", None)
                if settings is not None:
                    fr = settings.pop("frame_rate", None)
                    settings = CameraSettings(
                        **settings,
                        frame_rate=opt(CfgFraction, fr),
                    )
                poss = c.pop("possible_settings", None)
                if poss is not None:
                    poss = [
                        CameraSettings(
                            **{k: v for k, v in p.items() if k != "frame_rate"},
                            frame_rate=opt(CfgFraction, p.get("frame_rate")),
                        )
                        for p in poss
                    ]
                subs = c.pop("subsystems", {})
                subsystems = CameraSubsystems(
                    mjpeg=opt(MjpegSubsys, subs.get("mjpeg")),
                    capriltags=opt(CAprilTagsSubsys, subs.get("capriltags")),
                    ml=opt(MlSubsys, subs.get("ml")),
                    custom=list(subs.get("custom", [])),
                )
                offs = c.pop("cam_offsets", None)
                cam_offsets = (
                    CameraOffsets(
                        translation=CameraOffsetDimensions(**offs["translation"]),
                        rotation=CameraOffsetDimensions(**offs["rotation"]),
                    )
                    if offs
                    else CameraOffsets()
                )
                orientation = VideoOrientation(c.pop("orientation", "none"))
                cameras.append(
                    Camera(
                        settings=settings,
                        possible_settings=poss,
                        subsystems=subsystems,
                        cam_offsets=cam_offsets,
                        orientation=orientation,
                        **c,
                    )
                )

        custom = {
            k: CustomSubsystem(**v)
            for k, v in d.get("custom_subsystems", {}).items()
        }
        return Config(
            team_number=d.get("team_number", 0xFFFF),
            ntables_ip=d.get("ntables_ip"),
            rerun=opt(Rerun, d.get("rerun")),
            cameras=cameras,
            device_name=d.get("device_name"),
            field_layout=d.get("field_layout"),
            field_layouts=d.get("field_layouts"),
            custom_subsystems=custom,
            mesh=opt(MeshCfg, d.get("mesh")),
        )

    @staticmethod
    def loads(text: str) -> "Config":
        return Config.from_dict(tomllib.loads(text))

    @staticmethod
    def load(path: str) -> "Config":
        with open(path, "rb") as f:
            return Config.from_dict(tomllib.load(f))

    @staticmethod
    def load_with_fallback(paths=CONFIG_SEARCH_PATHS) -> "Config":
        """/boot -> /etc -> ./ -> defaults (crates/chalkydri/src/main.rs:76-87)."""
        import os

        for p in paths:
            if os.path.exists(p):
                try:
                    return Config.load(p)
                except (OSError, tomllib.TOMLDecodeError):
                    continue
        return Config()

    def to_dict(self) -> dict:
        def clean(v):
            if isinstance(v, dict):
                return {k: clean(x) for k, x in v.items() if x is not None}
            if isinstance(v, list):
                return [clean(x) for x in v]
            if isinstance(v, Enum):
                return v.value
            return v

        return clean(asdict(self))

    def dumps(self) -> str:
        return _toml_dumps(self.to_dict())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n") + '"'
    raise TypeError(f"unsupported TOML value {type(v)}")


def _toml_dumps(d: dict, prefix: str = "") -> str:
    """Minimal TOML writer (stdlib has no dumper): scalars, nested tables,
    arrays of tables, string lists."""
    lines = []
    tables = []
    for k, v in d.items():
        if isinstance(v, dict):
            tables.append((k, v, False))
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            tables.append((k, v, True))
        elif isinstance(v, list):
            lines.append(f"{k} = [" + ", ".join(_toml_value(x) for x in v) + "]")
        else:
            lines.append(f"{k} = {_toml_value(v)}")
    out = "\n".join(lines)
    for k, v, is_array in tables:
        full = f"{prefix}{k}"
        if is_array:
            for item in v:
                out += f"\n\n[[{full}]]\n" + _toml_dumps(item, prefix=f"{full}.")
        else:
            body = _toml_dumps(v, prefix=f"{full}.")
            out += f"\n\n[{full}]\n" + body
    return out


class _CfgHandle:
    """Process-wide config, mirroring the reference's ``Cfg: RwLock<Config>``
    global (chalkydri_core/src/config.rs:14)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._config = Config()

    def read(self) -> Config:
        with self._lock:
            return self._config

    def write(self, config: Config) -> None:
        with self._lock:
            self._config = config


Cfg = _CfgHandle()
