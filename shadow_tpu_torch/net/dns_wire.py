"""Minimal DNS wire protocol: answer A-record queries from the sim DNS.

The reference exposes host names to managed code via an /etc/hosts-style
file (src/main/network/dns.rs:81-190 + the hosts-file export).  Our
hybrid fd-space keeps file I/O native, so instead we answer the *DNS
protocol itself*: any UDP datagram a managed process sends to port 53 is
intercepted in the syscall layer and answered from the simulation's name
table — libc's getaddrinfo works unmodified, whatever resolver
/etc/resolv.conf names.

The port's copy of `shadow_tpu/net/dns_wire.py`.
"""

from __future__ import annotations

import struct

QTYPE_A = 1
QTYPE_AAAA = 28
QCLASS_IN = 1

FLAG_RESPONSE = 0x8000
FLAG_RD = 0x0100
FLAG_RA = 0x0080
RCODE_NXDOMAIN = 3


def parse_qname(data: bytes, off: int):
    """-> (name, offset-after) or (None, off) on malformed input."""
    labels = []
    while True:
        if off >= len(data):
            return None, off
        n = data[off]
        if n == 0:
            off += 1
            break
        if n & 0xC0:  # compression pointers: not expected in queries
            return None, off
        off += 1
        if off + n > len(data):
            return None, off
        labels.append(data[off:off + n])
        off += n
    try:
        return b".".join(labels).decode("ascii").lower(), off
    except UnicodeDecodeError:
        return None, off


def answer_query(query: bytes, resolve) -> bytes | None:
    """Build a response for one A/AAAA query.

    `resolve(name) -> ip int | None`.  Returns response bytes, or None
    when the datagram isn't a well-formed single-question query (the
    caller then lets it travel the simulated network like any packet).
    """
    if len(query) < 12:
        return None
    qid, flags, qdcount, _an, _ns, _ar = struct.unpack_from(">6H", query, 0)
    if flags & FLAG_RESPONSE or qdcount != 1:
        return None
    name, off = parse_qname(query, 12)
    if name is None or off + 4 > len(query):
        return None
    qtype, qclass = struct.unpack_from(">2H", query, off)
    off += 4
    if qclass != QCLASS_IN:
        return None
    question = query[12:off]

    ip = resolve(name)
    rflags = FLAG_RESPONSE | FLAG_RA | (flags & FLAG_RD)
    if ip is None:
        header = struct.pack(">6H", qid, rflags | RCODE_NXDOMAIN, 1, 0, 0, 0)
        return header + question
    if qtype == QTYPE_A:
        answer = (b"\xc0\x0c" +                      # pointer to qname
                  struct.pack(">2HIH", QTYPE_A, QCLASS_IN, 60, 4) +
                  int(ip).to_bytes(4, "big"))
        header = struct.pack(">6H", qid, rflags, 1, 1, 0, 0)
        return header + question + answer
    # AAAA (or other types): NOERROR with zero answers -> libc falls
    # back to the A result.
    header = struct.pack(">6H", qid, rflags, 1, 0, 0, 0)
    return header + question
