"""Sans-I/O TCP (ref: the reference's Rust tcp crate, src/lib/tcp/).

`TcpConnection` is a pure state machine: packets in, packets out, explicit
`now` on every call, timers surfaced as `next_timer_expiry()` — no
sockets, no host, no clock of its own. The same design goal as the
reference's `Dependencies` trait (src/lib/tcp/src/lib.rs:109-144): unit
tests drive it with a fake clock (tests/test_tcp_unit.py), and the socket
layer (host/socket_tcp.py) adapts it to the simulated kernel.

State that the congestion/retransmit logic reads every round (snd_una,
snd_nxt, cwnd, ssthresh, rto deadline, dupacks) is kept as plain integer
fields deliberately: the planned vectorized stepping lifts exactly those
fields into struct-of-arrays batches for the TPU path.

The port's copy of `shadow_tpu/tcp/__init__.py`.
"""

from shadow_tpu_torch.tcp.connection import (  # noqa: F401
    TcpConnection, CLOSED, LISTEN, SYN_SENT, SYN_RECEIVED, ESTABLISHED,
    FIN_WAIT_1, FIN_WAIT_2, CLOSING, TIME_WAIT, CLOSE_WAIT, LAST_ACK,
    STATE_NAMES)
