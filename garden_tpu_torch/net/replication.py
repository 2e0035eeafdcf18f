"""Entity/body state replication over the network layer.

Port of `garden_tpu.net.replication`: NetworkSystem's entity-UID map and
NetworkComponent (clientUID, entityUID, isClientOwned), and the body
snapshot flow — the server encodes the dynamic bodies within a view radius
(`gather_snapshots`), the client applies a received snapshot before
stepping (`apply_snapshots`); characters replicate as the 'c' message
(`gather_character` / `apply_character`).

A gather reads the state back to the host once, as one packed tensor, not
once per body or per field. An apply uploads its rows once and writes them
with `index_put`; a payload that names one body twice keeps its last entry
for that body.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from garden_tpu_torch.core.ecs import ComponentDef, Field, System
from garden_tpu_torch.net.protocol import (
    NetRigidbody,
    StreamInput,
    StreamOutput,
    decode_body_snapshot,
    encode_body_snapshot,
)

NETWORK = ComponentDef(
    "network",
    {
        "client_uid": Field((), np.int64, 0),
        "entity_uid": Field((), np.int64, 0),
        "is_client_owned": Field((), np.bool_, False),
    },
)

# message type chars (the rigidbody and character "c" conventions)
MSG_RIGIDBODY = "r"
MSG_CHARACTER = "c"


class NetworkSystem(System):
    """Entity-UID <-> entity registry."""

    component = NETWORK

    def __init__(self) -> None:
        self._uid_to_entity: Dict[int, int] = {}

    def bind(self, entity: int, entity_uid: int, client_uid: int = 0,
             is_client_owned: bool = False) -> None:
        self.world.add_component(entity, "network", entity_uid=entity_uid,
                                 client_uid=client_uid,
                                 is_client_owned=is_client_owned)
        self._uid_to_entity[entity_uid] = entity

    def entity_of(self, uid: int) -> Optional[int]:
        return self._uid_to_entity.get(uid)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _read_back(tensors) -> List[np.ndarray]:
    """The tensors (or arrays) on the host, read back in one transfer: each
    is packed as int32 words, a float32 by its bits, so every value returns
    exactly (floats as float32, bools as bool, integers as int32)."""
    dev = tensors[0].device
    tensors = [torch.as_tensor(t, device=dev) for t in tensors]
    words = [t.view(torch.int32) if t.dtype == torch.float32 else t.to(torch.int32)
             for t in tensors]
    packed = _host(torch.cat([w.reshape(-1) for w in words]))
    out, at = [], 0
    for t in tensors:
        chunk = packed[at:at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
        if t.dtype == torch.float32:
            chunk = chunk.view(np.float32)
        elif t.dtype == torch.bool:
            chunk = chunk.astype(bool)
        out.append(chunk)
    return out


def gather_snapshots(
    physics_state: Dict,
    body_uid: np.ndarray,          # int64[N] (-1 = not replicated)
    view_center=(0.0, 0.0, 0.0),
    view_radius: float = math.inf,
) -> bytes:
    """Server side: encode dynamic bodies within the view radius."""
    b = physics_state["bodies"]
    eligible = b["has"] & (b["motion"] == 2)
    pos, quat, linvel, angvel, eligible = _read_back(
        [b["pos"], b["quat"], b["linvel"], b["angvel"], eligible])
    center = np.asarray(view_center, np.float32)

    snaps: List[NetRigidbody] = []
    for i in np.nonzero(eligible & (body_uid >= 0))[0]:
        if np.linalg.norm(pos[i] - center) > view_radius:
            continue
        snaps.append(NetRigidbody(
            uid=int(body_uid[i]),
            position=tuple(pos[i]),
            rotation=tuple(quat[i]),
            linear_velocity=tuple(linvel[i]),
            angular_velocity=tuple(angvel[i]),
        ))
    return encode_body_snapshot(snaps)


def gather_character(
    physics_state: Dict,
    char_components: Dict,
    entity_uid: Dict[int, int],
) -> bytes:
    """Encode character states (the 'c' message): uid, position, velocity,
    grounded."""
    b = physics_state["bodies"]
    pos, lv, has, body, grounded = _read_back(
        [b["pos"], b["linvel"], char_components["has"], char_components["body"],
         char_components["grounded"]])
    out = StreamOutput()
    ents = [e for e in np.nonzero(has & (body >= 0))[0]
            if int(e) in entity_uid]
    out.write_u16(len(ents))
    for e in ents:
        bi = int(body[e])
        out.write_u64(entity_uid[int(e)])
        out.write_vec3(pos[bi])
        out.write_vec3(lv[bi])
        out.write_u8(1 if grounded[e] else 0)
    return out.data()


def _put_bodies(physics_state: Dict, rows: Dict[int, tuple], names) -> Dict:
    """Write rows {body: (values of each name, concatenated)} into the named
    (N, k) body arrays with one upload and one index_put each."""
    b = physics_state["bodies"]
    dev = b["pos"].device
    idx = torch.tensor(list(rows), dtype=torch.long, device=dev)
    vals = torch.tensor(np.asarray(list(rows.values()), np.float32), device=dev)
    out, col = {}, 0
    for n in names:
        k = b[n].shape[1]
        out[n] = b[n].index_put((idx,), vals[:, col:col + k])
        col += k
    return dict(physics_state, bodies=dict(b, **out))


def apply_character(
    physics_state: Dict,
    char_components: Dict,
    payload: bytes,
    uid_to_entity: Dict[int, int],
) -> Dict:
    """Decode + apply received character states ('c' message receive side).
    Returns the updated physics state (grounded flags are advisory client
    state and land in the component store separately). A body named twice
    keeps its last entry."""
    inp = StreamInput(payload)
    n = inp.read_u16()
    body = _host(char_components["body"])
    rows: Dict[int, tuple] = {}
    for _ in range(n):
        uid = inp.read_u64()
        p = inp.read_vec3()
        v = inp.read_vec3()
        inp.read_u8()  # grounded (advisory)
        e = uid_to_entity.get(uid)
        if e is None or body[e] < 0:
            continue
        rows[int(body[e])] = tuple(p) + tuple(v)
    if not rows:
        return physics_state
    return _put_bodies(physics_state, rows, ("pos", "linvel"))


def apply_snapshots(
    physics_state: Dict,
    payload: bytes,
    uid_to_body: Dict[int, int],
) -> Dict:
    """Client side: apply a received snapshot before stepping. Returns the
    updated physics state. A body named twice keeps its last entry."""
    rows: Dict[int, tuple] = {}
    for s in decode_body_snapshot(payload):
        body = uid_to_body.get(s.uid)
        if body is None:
            continue
        rows[int(body)] = (tuple(s.position) + tuple(s.rotation)
                           + tuple(s.linear_velocity) + tuple(s.angular_velocity))
    if not rows:
        return physics_state
    return _put_bodies(physics_state, rows, ("pos", "quat", "linvel", "angvel"))
