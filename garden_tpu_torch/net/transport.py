"""TCP client/server transport with per-session dispatch.

Rebuild of ClientNetworkSystem / ServerNetworkSystem (include/garden/system/
network/client.hpp:33 over nets::IStreamClient, server.hpp:82 over
nets::IStreamServer with per-session locks): an asyncio stream server that
manages ClientSessions and dispatches framed messages to registered
INetworkable handlers by their one-character message type. Host-side by
design — networking never enters the frame step (SURVEY.md section 5.8).
A copy of `garden_tpu.net.transport` over the port's `net/protocol.py`.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Awaitable, Callable, Dict, List, Optional

from garden_tpu_torch.net.protocol import FrameDecoder, frame_message

Handler = Callable[["Session", str, bytes], None]


class Session:
    """One connected peer (the ClientSession analog, network.hpp:32-406)."""

    _next_id = 1

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.reader = reader
        self.writer = writer
        self.id = Session._next_id
        Session._next_id += 1
        self.decoder = FrameDecoder()
        self.closed = False

    def send(self, msg_type: str, payload: bytes) -> None:
        if not self.closed:
            self.writer.write(frame_message(msg_type, payload))

    async def drain(self) -> None:
        await self.writer.drain()


class StreamServer:
    """Asyncio TCP server dispatching framed messages to handlers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self.sessions: List[Session] = []
        self._handlers: Dict[str, Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self.on_connect: Optional[Callable[[Session], None]] = None
        self.on_disconnect: Optional[Callable[[Session], None]] = None

    def register(self, msg_type: str, handler: Handler) -> None:
        """INetworkable registration: one-char message type -> handler."""
        self._handlers[msg_type] = handler

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def _handle_client(self, reader, writer) -> None:
        session = Session(reader, writer)
        self.sessions.append(session)
        if self.on_connect:
            self.on_connect(session)
        try:
            while True:
                data = await reader.read(4096)
                if not data:
                    break
                for msg_type, payload in session.decoder.feed(data):
                    handler = self._handlers.get(msg_type)
                    if handler:
                        handler(session, msg_type, payload)
        finally:
            session.closed = True
            self.sessions.remove(session)
            if self.on_disconnect:
                self.on_disconnect(session)
            writer.close()

    def broadcast(self, msg_type: str, payload: bytes) -> None:
        for s in list(self.sessions):
            s.send(msg_type, payload)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()


class StreamClient:
    """Asyncio TCP client (ClientNetworkSystem analog)."""

    def __init__(self) -> None:
        self._handlers: Dict[str, Handler] = {}
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.decoder = FrameDecoder()
        self.connected = False

    def register(self, msg_type: str, handler: Handler) -> None:
        self._handlers[msg_type] = handler

    async def connect(self, host: str, port: int) -> None:
        self.reader, self.writer = await asyncio.open_connection(host, port)
        self.connected = True

    def send(self, msg_type: str, payload: bytes) -> None:
        assert self.writer is not None
        self.writer.write(frame_message(msg_type, payload))

    async def poll(self) -> int:
        """Read available data and dispatch; returns messages handled."""
        assert self.reader is not None
        try:
            data = await asyncio.wait_for(self.reader.read(4096), timeout=0.05)
        except asyncio.TimeoutError:
            return 0
        if not data:
            self.connected = False
            return 0
        count = 0
        for msg_type, payload in self.decoder.feed(data):
            handler = self._handlers.get(msg_type)
            if handler:
                handler(None, msg_type, payload)
            count += 1
        return count

    async def close(self) -> None:
        if self.writer:
            self.writer.close()
        self.connected = False


class DatagramEndpoint:
    """UDP datagram transport (the nets datagram path the reference's
    client/server expose alongside streams, network/client.hpp:33 /
    server.hpp:34: IStreamClient's datagram sends for unreliable state).

    Messages reuse the 1-char-type framing WITHOUT the length prefix (one
    datagram = one message): [type byte][payload]. Unreliable by contract —
    suited to NetRigidbody snapshots where the newest state supersedes."""

    def __init__(self) -> None:
        self.transport: Optional[asyncio.DatagramTransport] = None
        self.handlers: Dict[str, Callable] = {}
        self.peer: Optional[tuple] = None
        self.received = 0

    def register(self, msg_type: str, handler) -> None:
        assert len(msg_type) == 1
        self.handlers[msg_type] = handler

    class _Protocol(asyncio.DatagramProtocol):
        def __init__(self, owner: "DatagramEndpoint") -> None:
            self.owner = owner

        def connection_made(self, transport) -> None:
            self.owner.transport = transport

        def datagram_received(self, data: bytes, addr) -> None:
            if not data:
                return
            msg_type = chr(data[0])
            self.owner.received += 1
            h = self.owner.handlers.get(msg_type)
            if h is not None:
                h(addr, msg_type, data[1:])

    async def bind(self, host: str = "127.0.0.1", port: int = 0) -> tuple:
        loop = asyncio.get_running_loop()
        self.transport, _ = await loop.create_datagram_endpoint(
            lambda: DatagramEndpoint._Protocol(self),
            local_addr=(host, port))
        return self.transport.get_extra_info("sockname")

    def send_to(self, addr: tuple, msg_type: str, payload: bytes) -> None:
        assert self.transport is not None
        self.transport.sendto(msg_type.encode()[:1] + payload, addr)

    def close(self) -> None:
        if self.transport is not None:
            self.transport.close()
