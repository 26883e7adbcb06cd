"""The span kernels' round-boundary sample law, built for the host.

`sample_part` of csrc/tcp_round_end.cuh and of csrc/phold_round_end.cuh
(the law in csrc/sample_rows.cuh, each family's columns wired to it)
compiled with the system C++ compiler and held exactly (integer law,
tolerance 0) against the plain loops' round-end sample
(ops/span_common.py `fabric_values`, trace/recorder.py `grid_sampled`
and the TCP loop's TEL_FIELDS columns) on seeded numpy span states:
hosts with an empty and a full CoDel ring (the ring's head wrapped past
its end), buckets
before, at and past their refill and never stepped, parked and idle
relays, links that never carried a packet; rounds that do and do not
cross the sampling grid; the rows split among teams of 1, 7 and 32
ranks.  A round past the buffer's rows writes nothing, a read of more
rows than the buffer holds raises, and a recording runner clamps its
spans to TEL_ROWS / FAB_ROWS = 64 rounds.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from shadow_tpu_torch.ops import phold_span_kernel as pk
from shadow_tpu_torch.ops import tcp_span_kernel as tsk
from shadow_tpu_torch.ops.queues import REFILL_NS
from shadow_tpu_torch.ops.span_common import FAB_COLS, fabric_values
from shadow_tpu_torch.ops.span_mesh import SpanMeshMixin
from shadow_tpu_torch.ops.tcp_span import TEL_FIELDS
from shadow_tpu_torch.ops.window_table import SAMPLE_ROWS_MAX, SampleRows
from shadow_tpu_torch.trace.events import (FB_DTYPE, TEL_DTYPE,
                                           TEL_FIELD_NAMES)
from shadow_tpu_torch.trace.recorder import grid_sampled

# The state columns a sample reads, in the shims' order.
HOST_KEYS = ("cq_len", "cq_pos", "cq_enq", "codel_bytes", "codel_enq_pkts",
             "codel_dropped", "codel_marked", "r1_pending", "r2_pending",
             "r1_bal", "r2_bal", "r1_next", "r2_next", "r1_cap", "r2_cap",
             "r1_refill", "r2_refill", "r1_stalls", "r2_stalls",
             "eth_psent", "eth_bsent", "eth_precv", "eth_brecv")
CONN_KEYS = tuple(col for _n, col in TEL_FIELDS)

# The host-key fields of each family's Ops, in HOST_KEYS order; the
# PHOLD family's marks are a round-end operand.
_TCP_HOST = ("o.cq_len o.cq_pos o.cq_enq o.codel_bytes o.enq_pkts "
             "o.cd_dropped o.codel_marked o.r1_pending o.r2_pending o.r1_bal "
             "o.r2_bal o.r1_next o.r2_next o.r1_cap o.r2_cap o.r1_refill "
             "o.r2_refill o.r1_stalls o.r2_stalls o.eth_psent o.eth_bsent "
             "o.eth_precv o.eth_brecv").split()
_PHOLD_HOST = [f.replace("o.codel_marked", "r.codel_marked")
               for f in _TCP_HOST]
_TCP_CONN = ("o.c_cwnd o.c_ssthresh o.c_srtt o.c_rto o.c_rtobackoff "
             "o.c_sblen o.c_rblen o.c_rtxcount o.c_sackskip "
             "o.c_ceseen").split()


def _shim(header: str, ns: str, host: list, conn: list, ring: str,
          tel: bool) -> str:
    sets = [f"  {f} = (decltype({f}))c[{k}];" for k, f in enumerate(host)]
    sets += [f"  {f} = (decltype({f}))c[{len(host) + k}];"
             for k, f in enumerate(conn)]
    tel_rows = ("  r.tel_t = rows[0];\n"
                "  for (int k = 0; k < stt::kTelCols; k++) "
                "r.tel[k] = rows[1 + k];\n"
                "  q.tel_iv = w[5];\n  p.conns = w[7];\n") if tel else ""
    return f"""
#include <cstring>
#include "{header}"
namespace ns = {ns};
// c: the state columns (HOST_KEYS, then CONN_KEYS); rows: the rows'
// buffers (tel_t, the tel columns, fab_t, the fab columns); w: start,
// window_end, tel_n, fab_n, team, tel_iv, fab_iv, conns, n, ring, rows,
// refill_ns.
extern "C" void stt_sample(int64_t* const* c, int64_t* const* rows,
                           const long long* w) {{
  ns::SpanOps so;
  std::memset(&so, 0, sizeof so);
  ns::SpanParams sp;
  std::memset(&sp, 0, sizeof sp);
  ns::Ops& o = so.w;
  ns::RoundOps& r = so.r;
  ns::Params& p = sp.w;
  ns::RoundParams& q = sp.r;
{chr(10).join(sets)}
{tel_rows}  const int f0 = 1 + stt::kTelCols;
  r.fab_t = rows[f0];
  for (int k = 0; k < stt::kFabCols; k++) r.fab[k] = rows[f0 + 1 + k];
  q.fab_iv = w[6];
  p.n = w[8];
  p.{ring} = w[9];
  q.rows = w[10];
  p.refill_ns = w[11];
  const stt::SampleRun s = {{w[2], w[3]}};
  for (int k = 0; k < w[4]; k++)
    ns::sample_part(o, r, p, q, s, w[0], w[1], k, w[4]);
}}
"""


def _build(tmp, name, src):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    (tmp / f"{name}.cpp").write_text(src)
    csrc = os.path.join(os.path.dirname(pk.__file__), "..", "csrc")
    out = str(tmp / f"lib{name}.so")
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", csrc,
                    "-o", out, str(tmp / f"{name}.cpp")], check=True)
    lib = ctypes.CDLL(out)
    lib.stt_sample.argtypes = [ctypes.c_void_p] * 3
    lib.stt_sample.restype = None
    return lib


@pytest.fixture(scope="module")
def laws(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sample_laws")
    return {
        "tcp": _build(tmp, "tcp_sample", _shim(
            "tcp_round_end.cuh", "stt::tcp", _TCP_HOST, _TCP_CONN,
            "cap_cq", True)),
        "phold": _build(tmp, "phold_sample", _shim(
            "phold_round_end.cuh", "stt::phold", _PHOLD_HOST, [], "cap_c",
            False)),
    }


def seeded_state(seed: int, n: int, conns: int, ring: int, window_end: int):
    """A span state's sampled columns with every edge of the law."""
    rng = np.random.default_rng(seed)
    st = {}
    pos = rng.integers(0, 4 * ring, n)
    depth = rng.integers(0, ring + 1, n)
    depth[0], depth[1] = 0, ring           # an empty and a full ring
    pos[1] = 3 * ring - 2                  # the full ring's head wrapped
    st["cq_pos"], st["cq_len"] = pos, pos + depth
    st["cq_enq"] = window_end - rng.integers(0, 10**9, (n, ring))
    for k in ("codel_bytes", "codel_enq_pkts", "codel_dropped",
              "codel_marked", "r1_stalls", "r2_stalls", "eth_bsent",
              "eth_brecv"):
        st[k] = rng.integers(0, 10**9, n)
    for k in ("eth_psent", "eth_precv"):
        st[k] = rng.integers(0, 3, n) * rng.integers(0, 10**6, n)
    st["eth_psent"][2] = st["eth_precv"][2] = 0  # a link never used
    for r in (1, 2):
        st[f"r{r}_pending"] = rng.integers(0, 2, n)
        st[f"r{r}_cap"] = rng.integers(1, 10**6, n)
        st[f"r{r}_refill"] = rng.integers(1, 10**5, n)
        st[f"r{r}_bal"] = rng.integers(0, 10**6, n)
        nxt = window_end + rng.integers(-5 * REFILL_NS, 5 * REFILL_NS, n)
        nxt[0] = 0                    # never stepped
        nxt[1] = window_end           # at its refill
        nxt[2] = window_end + 1       # just before it
        nxt[3] = window_end - 3 * REFILL_NS  # four refills due
        st[f"r{r}_next"] = nxt
    for k in CONN_KEYS:
        st[k] = rng.integers(0, 10**9, conns + 1)  # + the trash row
    return st


def _ptrs(arrays):
    return (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data for a in arrays])


def host_sample(lib, st, rows_buf, start, window_end, tel_n, fab_n, team,
                tel_iv, fab_iv, conns, n, ring, rows):
    cols = [np.ascontiguousarray(st[k], dtype=np.int64)
            for k in HOST_KEYS + CONN_KEYS]
    w = (ctypes.c_longlong * 12)(start, window_end, tel_n, fab_n, team,
                                 tel_iv, fab_iv, conns, n, ring, rows,
                                 REFILL_NS)
    lib.stt_sample(_ptrs(cols), _ptrs(rows_buf), w)


def row_buffers(rows, conns, n):
    bufs = [np.zeros(rows, np.int64)]
    bufs += [np.zeros(rows * conns, np.int64) for _ in TEL_FIELD_NAMES]
    bufs += [np.zeros(rows, np.int64)]
    bufs += [np.zeros(rows * n, np.int64) for _ in FAB_COLS]
    return bufs


def plain_sample(st, window_end, ring, conns):
    t = {k: torch.tensor(v) for k, v in st.items()}
    fab = {c: v.numpy() for c, v in
           fabric_values(t, window_end, ring, REFILL_NS).items()}
    tel = {n: st[c][:conns] for n, c in TEL_FIELDS}
    return tel, fab


ROUNDS = [  # (start, window_end, interval): which cross the grid
    (0, 1_000_000, 1), (999_999_000, 1_000_001_000, 1_000_000_000),
    (1_000_000_000, 1_001_000_000, 1_000_000_000),
    (4_000_000, 5_000_000, 1_000_000), (4_000_001, 4_999_999, 1_000_000)]


@pytest.mark.parametrize("family", ["tcp", "phold"])
@pytest.mark.parametrize("seed,team", [(1, 1), (2, 7), (3, 32)])
def test_torch_sample_law_matches_plain_round_end(laws, family, seed, team):
    n, conns, ring, rows = 37, 53, 16, 4
    tel_on = family == "tcp"
    for r_i, (start, window_end, iv) in enumerate(ROUNDS):
        st = seeded_state(seed * 10 + r_i, n, conns, ring, window_end)
        bufs = row_buffers(rows, conns, n)
        row = r_i % rows
        host_sample(laws[family], st, bufs, start, window_end, row, row,
                    team, iv if tel_on else 0, iv, conns, n, ring, rows)
        due = grid_sampled(start, window_end, iv)
        tel, fab = plain_sample(st, window_end, ring, conns)
        fab_at = 1 + len(TEL_FIELD_NAMES)
        if not due:
            assert not any(b.any() for b in bufs), (start, window_end, iv)
            continue
        assert bufs[fab_at][row] == window_end
        for k, c in enumerate(FAB_COLS):
            got = bufs[fab_at + 1 + k].reshape(rows, n)
            np.testing.assert_array_equal(got[row], fab[c], err_msg=c)
            assert not got[np.arange(rows) != row].any()
        if tel_on:
            assert bufs[0][row] == window_end
            for k, name in enumerate(TEL_FIELD_NAMES):
                got = bufs[1 + k].reshape(rows, conns)
                np.testing.assert_array_equal(got[row], tel[name])
        else:
            assert not any(b.any() for b in bufs[:fab_at])


def test_torch_sample_law_edges_hold(laws):
    """The edge hosts of the seeded state read as the reference reads
    them: no flag and no sojourn on an empty ring, the full ring's head
    at pos % ring, a bucket never stepped or before its refill at its
    balance, four refills added (up to the cap) three refills late."""
    n, conns, ring, rows, we = 8, 4, 16, 2, 10**9 + 17
    st = seeded_state(5, n, conns, ring, we)
    bufs = row_buffers(rows, conns, n)
    host_sample(laws["tcp"], st, bufs, we - 1, we, 0, 0, 1, 1, 1, conns,
                n, ring, rows)
    fab = {c: bufs[1 + len(TEL_FIELD_NAMES) + 1 + k].reshape(rows, n)[0]
           for k, c in enumerate(FAB_COLS)}
    assert fab["qdepth"][0] == 0 and fab["sojourn"][0] == 0
    assert fab["flags"][0] & 1 == 0
    assert fab["qdepth"][1] == ring and fab["flags"][1] & 1
    head = st["cq_enq"][1][st["cq_pos"][1] % ring]
    assert fab["sojourn"][1] == we - head
    assert fab["flags"][2] & 8 == 0  # the unused link
    for r in (1, 2):
        bal, cap, refill = (st[f"r{r}_{k}"] for k in ("bal", "cap",
                                                      "refill"))
        got = fab[f"r{r}_bal"]
        assert got[0] == bal[0] and got[2] == bal[2]
        assert got[1] == min(cap[1], bal[1] + refill[1])
        assert got[3] == min(cap[3], bal[3] + 4 * refill[3])


@pytest.mark.parametrize("family", ["tcp", "phold"])
def test_torch_sample_law_writes_no_row_past_the_buffer(laws, family):
    n, conns, ring, rows = 5, 6, 8, 3
    st = seeded_state(9, n, conns, ring, 2_000)
    bufs = row_buffers(rows, conns, n)
    host_sample(laws[family], st, bufs, 1_000, 2_000, rows, rows, 4,
                1 if family == "tcp" else 0, 1, conns, n, ring, rows)
    assert not any(b.any() for b in bufs)


def test_torch_sample_rows_read_refuses_an_overflow():
    """A count past the block's rows (a span the runner did not clamp)
    raises on the read instead of emitting rows that were never
    written."""
    class Table(SampleRows):
        FAMILY = "t"
        SAMPLE_CHANNELS = (("fab", "fab_iv", FAB_COLS, "n"),)
        params = {"fab_iv": 1}
        dims = {"n": 3}
    t = Table()
    block = torch.zeros(t.sample_words(2), dtype=torch.int64)
    t.place_rows(block, 0, 2)
    assert t.read_rows(block.numpy(), 0, {"fab": 2})["fab_n"] == 2
    with pytest.raises(RuntimeError, match="sample rows"):
        t.read_rows(block.numpy(), 0, {"fab": 3})


@pytest.mark.parametrize("netstat,fabric,want", [
    (False, False, 256), (True, False, 64), (False, True, 64),
    (True, True, 64)])
def test_torch_recording_spans_clamp_to_64_rounds(netstat, fabric, want):
    class Runner(SpanMeshMixin):
        MAX_ROUNDS = 256
    r = Runner()
    r.netstat = object() if netstat else None
    r.fabric = object() if fabric else None
    assert r._clamp_mr(None) == want and r._clamp_mr(1000) == want
    assert r._clamp_mr(16) == 16
    assert r.TEL_ROWS == r.FAB_ROWS == SAMPLE_ROWS_MAX == 64


def test_torch_sample_columns_are_the_records_fields():
    """The rows' columns are the channel records' fields, in order, and
    each kernel table expands its rows' operands to them."""
    assert tuple(n for n, _ in TEL_FIELDS) == TEL_FIELD_NAMES == \
        tuple(n for n, _ in TEL_DTYPE[6:])
    assert FAB_COLS == ("flags",) + tuple(n for n, _ in FB_DTYPE[3:])
    assert tsk.TcpSpanTable.SAMPLE_EXPAND == {"%": TEL_FIELD_NAMES,
                                              "&": FAB_COLS}
    assert pk.SpanTable.SAMPLE_EXPAND == {"&": FAB_COLS}
