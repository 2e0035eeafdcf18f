"""Binary stream message protocol.

Rebuild of the reference's network message core (include/garden/network.hpp:
32-406: StreamInput/StreamOutput binary readers/writers over the cfnptr/nets
stream, ClientSession, and the INetworkable interface where each system
declares a one-character message type and handlers — e.g. PhysicsSystem
messageType at physics.hpp:709, CharacterSystem "c").

Framing: [u16 length][u8 type char][payload]. Payloads are little-endian.
`NetRigidbody` mirrors the reference's body-state replication snapshot
(physics.hpp:702-709: position, rotation, linear/angular velocity per body
UID, sent within networkViewRadius).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, List, Optional, Tuple

MAX_MESSAGE = 65535


class StreamOutput:
    """Little-endian binary writer (ISerializer-flavored API)."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def write_u8(self, v: int): self._parts.append(struct.pack("<B", v))
    def write_u16(self, v: int): self._parts.append(struct.pack("<H", v))
    def write_u32(self, v: int): self._parts.append(struct.pack("<I", v))
    def write_u64(self, v: int): self._parts.append(struct.pack("<Q", v))
    def write_i32(self, v: int): self._parts.append(struct.pack("<i", v))
    def write_f32(self, v: float): self._parts.append(struct.pack("<f", v))

    def write_vec3(self, v) -> None:
        self._parts.append(struct.pack("<fff", float(v[0]), float(v[1]), float(v[2])))

    def write_quat(self, q) -> None:
        self._parts.append(struct.pack("<ffff", *(float(x) for x in q)))

    def write_string(self, s: str) -> None:
        data = s.encode("utf-8")
        self.write_u16(len(data))
        self._parts.append(data)

    def data(self) -> bytes:
        return b"".join(self._parts)


class StreamInput:
    """Little-endian binary reader."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._off = 0

    def _take(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self._data, self._off)
        self._off += size
        return vals

    def read_u8(self) -> int: return self._take("<B")[0]
    def read_u16(self) -> int: return self._take("<H")[0]
    def read_u32(self) -> int: return self._take("<I")[0]
    def read_u64(self) -> int: return self._take("<Q")[0]
    def read_i32(self) -> int: return self._take("<i")[0]
    def read_f32(self) -> float: return self._take("<f")[0]
    def read_vec3(self) -> Tuple[float, float, float]: return self._take("<fff")
    def read_quat(self): return self._take("<ffff")

    def read_string(self) -> str:
        n = self.read_u16()
        s = self._data[self._off:self._off + n].decode("utf-8")
        self._off += n
        return s

    def remaining(self) -> int:
        return len(self._data) - self._off


def frame_message(msg_type: str, payload: bytes) -> bytes:
    """[u16 len][u8 type][payload] (the nets stream-message framing)."""
    body = msg_type.encode("ascii")[:1] + payload
    if len(body) > MAX_MESSAGE:
        raise ValueError("message too large")
    return struct.pack("<H", len(body)) + body


class FrameDecoder:
    """Incremental stream -> framed messages."""

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, data: bytes) -> Iterator[Tuple[str, bytes]]:
        self._buf += data
        while len(self._buf) >= 2:
            (length,) = struct.unpack_from("<H", self._buf, 0)
            if len(self._buf) < 2 + length:
                break
            body = self._buf[2:2 + length]
            self._buf = self._buf[2 + length:]
            yield chr(body[0]), body[1:]


@dataclasses.dataclass
class NetRigidbody:
    """Body replication snapshot (physics.hpp:702-709 NetRigidbody)."""

    uid: int
    position: Tuple[float, float, float]
    rotation: Tuple[float, float, float, float]
    linear_velocity: Tuple[float, float, float]
    angular_velocity: Tuple[float, float, float]

    def encode(self, out: StreamOutput) -> None:
        out.write_u64(self.uid)
        out.write_vec3(self.position)
        out.write_quat(self.rotation)
        out.write_vec3(self.linear_velocity)
        out.write_vec3(self.angular_velocity)

    @classmethod
    def decode(cls, inp: StreamInput) -> "NetRigidbody":
        return cls(
            uid=inp.read_u64(),
            position=inp.read_vec3(),
            rotation=inp.read_quat(),
            linear_velocity=inp.read_vec3(),
            angular_velocity=inp.read_vec3(),
        )


def encode_body_snapshot(bodies: List[NetRigidbody]) -> bytes:
    out = StreamOutput()
    out.write_u16(len(bodies))
    for b in bodies:
        b.encode(out)
    return out.data()


def decode_body_snapshot(payload: bytes) -> List[NetRigidbody]:
    inp = StreamInput(payload)
    return [NetRigidbody.decode(inp) for _ in range(inp.read_u16())]
