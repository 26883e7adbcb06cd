"""DNS: host registration and name/IP resolution.

Ref: src/main/network/dns.rs:81-190. A flat registry (no hierarchical DNS,
like the reference): every host registers (host_id, ip, name) at build
time; managed code resolves via an /etc/hosts-style file (written into the
data dir) and via direct map lookups from the simulator side.
"""

from __future__ import annotations

from shadow_tpu_torch.net.graph import format_ip


class Dns:
    def __init__(self):
        self._by_name: dict[str, int] = {}   # name -> ip
        self._by_ip: dict[int, tuple[int, str]] = {}  # ip -> (host_id, name)

    def register(self, host_id: int, ip: int, name: str) -> None:
        if name in self._by_name:
            raise ValueError(f"duplicate hostname {name!r}")
        if ip in self._by_ip:
            raise ValueError(f"duplicate IP {format_ip(ip)}")
        self._by_name[name] = ip
        self._by_ip[ip] = (host_id, name)

    def ip_for_name(self, name: str) -> int | None:
        return self._by_name.get(name)

    def host_id_for_ip(self, ip: int) -> int | None:
        entry = self._by_ip.get(ip)
        return entry[0] if entry else None

    def name_for_ip(self, ip: int) -> str | None:
        entry = self._by_ip.get(ip)
        return entry[1] if entry else None

    def hosts_file_text(self) -> str:
        """The /etc/hosts contents exposed to managed code
        (dns.rs:120-150; path export worker.rs:632)."""
        lines = ["127.0.0.1 localhost"]
        for name, ip in sorted(self._by_name.items(), key=lambda kv: kv[1]):
            lines.append(f"{format_ip(ip)} {name}")
        return "\n".join(lines) + "\n"
