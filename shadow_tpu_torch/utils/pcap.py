"""Pcap capture, the port's copy of `shadow_tpu/utils/pcap.py`.

Classic libpcap (magic 0xA1B2C3D4, LINKTYPE_RAW = 101) with synthesized
IPv4 and TCP/UDP headers, stamped with emulated time.  The engine
captures on its hosts' interfaces and the Manager drains the records
each round (`write_fields`); an object-path host's interfaces write
their packets as they pass (`write_packet`).  The files are
byte-identical to the JAX package's for the same run.
"""

from __future__ import annotations

import struct

from shadow_tpu_torch.core import simtime

_LINKTYPE_RAW = 101
# net/packet.py's protocol number of UDP (anything else is TCP here).
PROTO_UDP = 17


def _inet_checksum(data: bytes) -> int:
    total = 0
    for i in range(0, len(data) - 1, 2):
        total += (data[i] << 8) | data[i + 1]
    if len(data) % 2:
        total += data[-1] << 8
    while total >> 16:
        total = (total & 0xFFFF) + (total >> 16)
    return ~total & 0xFFFF


def ipv4_header(src_host_id: int, seq: int, proto: int, src_ip: int,
                dst_ip: int, total_len: int) -> bytes:
    header = struct.pack(
        ">BBHHHBBH4s4s",
        0x45, 0, total_len, (src_host_id * 31 + seq) & 0xFFFF,
        0x4000,  # don't fragment
        64, proto, 0,
        src_ip.to_bytes(4, "big"), dst_ip.to_bytes(4, "big"))
    checksum = _inet_checksum(header)
    return header[:10] + struct.pack(">H", checksum) + header[12:]


def transport_header(proto: int, src_port: int, dst_port: int,
                     payload: bytes, tcp) -> bytes:
    """The UDP header, or the TCP one from `tcp` = (seq, ack, flags,
    window) or None."""
    if proto == PROTO_UDP:
        return struct.pack(">HHHH", src_port, dst_port, 8 + len(payload), 0)
    seq, ack, flags, window = tcp if tcp is not None else (0, 0, 0, 0)
    return struct.pack(">HHIIBBHHH", src_port, dst_port, seq, ack,
                       5 << 4, flags & 0xFF, min(window, 0xFFFF), 0, 0)


class PcapWriter:
    def __init__(self, path: str, capture_size: int = 65535):
        self._f = open(path, "wb")
        self.capture_size = capture_size
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                  capture_size, _LINKTYPE_RAW))

    def write_packet(self, sim_now: int, p) -> None:
        """One packet an object-path interface captured (net/packet.py
        Packet): the same frame as the engine's record of it."""
        t = p.tcp
        self.write_fields(sim_now, p.src_host_id, p.seq, p.protocol,
                          p.src_ip, p.src_port, p.dst_ip, p.dst_port,
                          p.payload, None if t is None
                          else (t.seq, t.ack, t.flags, t.window))

    def write_fields(self, sim_now: int, src_host_id: int, seq: int,
                     proto: int, src_ip: int, src_port: int, dst_ip: int,
                     dst_port: int, payload: bytes, tcp) -> None:
        """One captured packet, from the engine's record fields."""
        emu = simtime.emulated_from_sim(sim_now)
        ip_payload = transport_header(proto, src_port, dst_port, payload,
                                      tcp) + payload
        frame = ipv4_header(src_host_id, seq, proto, src_ip, dst_ip,
                            20 + len(ip_payload)) + ip_payload
        snap = frame[:self.capture_size]
        self._f.write(struct.pack("<IIII", emu // simtime.NSEC_PER_SEC,
                                  (emu % simtime.NSEC_PER_SEC) // 1000,
                                  len(snap), len(frame)))
        self._f.write(snap)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
