"""NETLINK_ROUTE sockets, minimally emulated (ref: socket/netlink.rs,
1,328 LoC).

Real network tools discover interfaces at startup via rtnetlink dumps —
glibc's getifaddrs() sends RTM_GETLINK + RTM_GETADDR and parses the
multipart replies.  This answers exactly those dumps from the simulated
interface table (lo 127.0.0.1/8 + eth0 host-ip/24), which is what the
reference's netlink socket serves too.  Everything else is answered
with NLMSG_ERROR(EOPNOTSUPP) so callers fail loudly instead of hanging.
"""

from __future__ import annotations

import errno
import struct

from shadow_tpu_torch.host.status import (S_ACTIVE, S_CLOSED, S_READABLE,
                                    S_WRITABLE, StatusOwner)

NLMSG_ERROR = 0x2
NLMSG_DONE = 0x3
RTM_NEWLINK = 16
RTM_GETLINK = 18
RTM_NEWADDR = 20
RTM_GETADDR = 22

NLM_F_MULTI = 0x2
NLM_F_REQUEST = 0x1
NLM_F_DUMP = 0x300

IFLA_IFNAME = 3
IFLA_MTU = 4
IFLA_ADDRESS = 1
IFA_ADDRESS = 1
IFA_LOCAL = 2
IFA_LABEL = 3

ARPHRD_LOOPBACK = 772
ARPHRD_ETHER = 1
IFF_UP = 0x1
IFF_LOOPBACK = 0x8
IFF_RUNNING = 0x40
AF_INET = 2
AF_UNSPEC = 0


def _align4(n: int) -> int:
    return (n + 3) & ~3


def _attr(rta_type: int, payload: bytes) -> bytes:
    hdr = struct.pack("<HH", 4 + len(payload), rta_type)
    return hdr + payload + b"\0" * (_align4(len(payload)) - len(payload))


def _nlmsg(msg_type: int, flags: int, seq: int, pid: int,
           payload: bytes) -> bytes:
    total = 16 + len(payload)
    return struct.pack("<IHHII", total, msg_type, flags, seq, pid) + \
        payload


def _link_msg(seq: int, pid: int, index: int, name: str, hw_type: int,
              flags: int, mtu: int) -> bytes:
    ifinfo = struct.pack("<BBHiII", AF_UNSPEC, 0, hw_type, index, flags,
                         0xffffffff)
    attrs = _attr(IFLA_IFNAME, name.encode() + b"\0")
    attrs += _attr(IFLA_MTU, struct.pack("<I", mtu))
    attrs += _attr(IFLA_ADDRESS, b"\0" * 6)
    return _nlmsg(RTM_NEWLINK, NLM_F_MULTI, seq, pid, ifinfo + attrs)


def _addr_msg(seq: int, pid: int, index: int, name: str, ip: int,
              prefix: int) -> bytes:
    ifaddr = struct.pack("<BBBBi", AF_INET, prefix, 0, 0, index)
    ip_bytes = int(ip).to_bytes(4, "big")
    attrs = _attr(IFA_ADDRESS, ip_bytes) + _attr(IFA_LOCAL, ip_bytes)
    attrs += _attr(IFA_LABEL, name.encode() + b"\0")
    return _nlmsg(RTM_NEWADDR, NLM_F_MULTI, seq, pid, ifaddr + attrs)


LOCALHOST = 0x7f000001


class NetlinkSocket(StatusOwner):
    """One NETLINK_ROUTE endpoint: requests are answered synchronously
    into the receive queue."""

    def __init__(self, host):
        super().__init__()
        self.host = host
        self.nonblocking = False
        self.nl_pid = 0  # autobound on first use (we only have 1 user)
        self._recv_q: list[bytes] = []
        self._status = S_ACTIVE | S_WRITABLE

    def bind(self, host, nl_pid: int) -> None:
        self.nl_pid = nl_pid or host.next_event_seq() + 0x10000

    def sendto(self, host, data: bytes, dest=None) -> int:
        off = 0
        while off + 16 <= len(data):
            length, msg_type, _flags, seq, _pid = struct.unpack_from(
                "<IHHII", data, off)
            if length < 16 or off + length > len(data):
                break
            self._answer(host, msg_type, seq)
            off += _align4(length)
        return len(data)

    def _answer(self, host, msg_type: int, seq: int) -> None:
        pid = self.nl_pid
        if msg_type == RTM_GETLINK:
            self._recv_q.append(_link_msg(
                seq, pid, 1, "lo", ARPHRD_LOOPBACK,
                IFF_UP | IFF_LOOPBACK | IFF_RUNNING, 65536))
            self._recv_q.append(_link_msg(
                seq, pid, 2, "eth0", ARPHRD_ETHER,
                IFF_UP | IFF_RUNNING, 1500))
            self._recv_q.append(_nlmsg(NLMSG_DONE, NLM_F_MULTI, seq,
                                       pid, struct.pack("<i", 0)))
        elif msg_type == RTM_GETADDR:
            self._recv_q.append(_addr_msg(seq, pid, 1, "lo",
                                          LOCALHOST, 8))
            self._recv_q.append(_addr_msg(seq, pid, 2, "eth0",
                                          self.host.ip, 24))
            self._recv_q.append(_nlmsg(NLMSG_DONE, NLM_F_MULTI, seq,
                                       pid, struct.pack("<i", 0)))
        else:
            self._recv_q.append(_nlmsg(
                NLMSG_ERROR, 0, seq, pid,
                struct.pack("<i", -errno.EOPNOTSUPP) + b"\0" * 16))
        self.adjust_status(host, S_READABLE, 0)

    def recvfrom(self, host, bufsize: int, peek: bool = False):
        if not self._recv_q:
            raise BlockingIOError(errno.EWOULDBLOCK, "empty")
        # A short buffer truncates (netlink semantics) — glibc always
        # passes page-sized buffers, and dumps coalesce per recv call.
        out = bytearray()
        taken = 0
        for msg in self._recv_q:
            if taken and len(out) + len(msg) > bufsize:
                break
            out += msg[:max(0, bufsize - len(out))]
            taken += 1
        if not peek:
            del self._recv_q[:taken]
            if not self._recv_q:
                self.adjust_status(host, 0, S_READABLE)
        return bytes(out), ("netlink", 0)

    def bytes_available(self) -> int:
        return len(self._recv_q[0]) if self._recv_q else 0

    def close(self, host) -> None:
        self.adjust_status(host, S_CLOSED,
                           S_ACTIVE | S_READABLE | S_WRITABLE)
