"""Streaming trace ingestion: raw pcap / CSV -> the drivers' packet_stream.

Hand-rolled parser for the classic libpcap capture format (24-byte global
header + 16-byte per-record headers; both byte orders, microsecond and
nanosecond magics) — no libpcap/scapy dependency.  Frames are decoded as
Ethernet (or raw-IP linktype) -> IPv4 -> TCP/UDP ports, and normalized into
the exact column dict
``repro_torch.data.synthetic_traffic.packet_stream`` produces: the
data-plane keys consumed by every driver
(``ts_us/pkt_len/src_ip/dst_ip/src_port/dst_port/proto``) plus the flow
bookkeeping the oracle paths use (``flow_idx/flow_pos/label``).

The reader is chunked: records are decoded ``chunk_pkts`` at a time, so a
multi-GB capture never materializes in host memory — only the fixed-size
column arrays of the packets actually kept (``limit=``) do.

``synthesize_pcap`` is the inverse: it writes a synthetic flow set out as
real pcap bytes (plus a per-flow label sidecar CSV, the stand-in for the
datasets' ground-truth files).  It is the correctness oracle: ``pcap ->
ingest -> packet_stream`` must equal the original synthetic stream
bit-for-bit.

The port's own copy of ``repro/data/trace_ingest.py`` (numpy and the
standard library only): the same parser, writer, error types and
messages, with ``Flow`` and ``packet_stream`` from the port's
``synthetic_traffic``.  ``TraceSpec`` is what ``FenixSystem.run_trace``
streams on the device driver.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import struct
from typing import Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.data import trace_formats as tf
from repro_torch.data.synthetic_traffic import Flow, packet_stream
from repro_torch.data.trace_formats import TraceFormatError

PCAP_MAGIC_US = 0xA1B2C3D4
PCAP_MAGIC_NS = 0xA1B23C4D
LINKTYPE_ETHERNET = 1
LINKTYPE_RAW = 101          # raw IPv4/IPv6, no link-layer header
ETHERTYPE_IPV4 = 0x0800

# column dtypes of the packet_stream dict (bit-identity contract)
STREAM_DTYPES = {
    "ts_us": np.int32, "pkt_len": np.int32,
    "src_ip": np.uint32, "dst_ip": np.uint32,
    "src_port": np.uint32, "dst_port": np.uint32, "proto": np.uint32,
    "flow_idx": np.int32, "flow_pos": np.int32, "label": np.int32,
}
PKT_COLS = ("ts_us", "pkt_len", "src_ip", "dst_ip", "src_port",
            "dst_port", "proto")

_TS_MOD = 2**31 - 1         # packet_stream's int32 timestamp wrap


def _open_binary(source):
    if hasattr(source, "read"):
        return source, False
    return open(os.fspath(source), "rb"), True


def _parse_global_header(hdr: bytes) -> Tuple[str, bool, int, int]:
    """-> (endianness, nanosecond?, snaplen, linktype)."""
    if len(hdr) == 0:
        raise TraceFormatError("empty pcap: no global header")
    if len(hdr) < 24:
        raise TraceFormatError(
            f"truncated pcap global header: got {len(hdr)} of 24 bytes")
    for endian in ("<", ">"):
        magic = struct.unpack(endian + "I", hdr[:4])[0]
        if magic in (PCAP_MAGIC_US, PCAP_MAGIC_NS):
            _vmaj, _vmin, _tz, _sig, snaplen, network = struct.unpack(
                endian + "HHiIII", hdr[4:24])
            return endian, magic == PCAP_MAGIC_NS, snaplen, network
    raise TraceFormatError(
        f"bad pcap magic 0x{struct.unpack('<I', hdr[:4])[0]:08x} "
        f"(expected 0x{PCAP_MAGIC_US:08x} or 0x{PCAP_MAGIC_NS:08x}, "
        f"either byte order)")


def _parse_frame(body: bytes, linktype: int):
    """One captured frame -> (pkt_len, src, dst, sport, dport, proto),
    or None for non-IPv4 frames (counted as skipped by the caller)."""
    if linktype == LINKTYPE_ETHERNET:
        if len(body) < 14:
            return None
        if body[12] != (ETHERTYPE_IPV4 >> 8) or \
                body[13] != (ETHERTYPE_IPV4 & 0xFF):
            return None
        ip = body[14:]
    else:                               # LINKTYPE_RAW
        ip = body
    if len(ip) < 20 or (ip[0] >> 4) != 4:
        return None
    ihl = (ip[0] & 0x0F) * 4
    if ihl < 20:
        return None
    total_len = (ip[2] << 8) | ip[3]
    proto = ip[9]
    src = int.from_bytes(ip[12:16], "big")
    dst = int.from_bytes(ip[16:20], "big")
    sport = dport = 0
    if proto in (6, 17) and len(ip) >= ihl + 4:
        sport = (ip[ihl] << 8) | ip[ihl + 1]
        dport = (ip[ihl + 2] << 8) | ip[ihl + 3]
    return total_len, src, dst, sport, dport, proto


def iter_pcap_packets(source, chunk_pkts: int = 65536,
                      stats: Optional[Dict[str, int]] = None
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Stream a pcap as column-array chunks of the 7 data-plane keys.

    Yields dicts with :data:`PKT_COLS` arrays of up to ``chunk_pkts``
    packets each; the file is read incrementally, so captures far larger
    than host memory stream through.  Timestamps are rebased to the first
    record when they exceed the int32 microsecond range (real epoch-stamped
    captures) and wrapped mod 2^31-1, exactly like ``packet_stream``;
    synthetic fixtures (already int32) pass through untouched.  Non-IPv4
    frames are skipped and counted in ``stats["skipped"]``.
    """
    if stats is None:
        stats = {}
    stats.setdefault("skipped", 0)
    f, should_close = _open_binary(source)
    try:
        endian, nanos, _snaplen, linktype = _parse_global_header(f.read(24))
        if linktype not in (LINKTYPE_ETHERNET, LINKTYPE_RAW):
            raise TraceFormatError(
                f"unsupported pcap linktype {linktype} (want "
                f"{LINKTYPE_ETHERNET}=Ethernet or {LINKTYPE_RAW}=raw IP)")
        rec_hdr = struct.Struct(endian + "IIII")
        offset = 24
        ts_base: Optional[int] = None
        cols: List[List[int]] = [[] for _ in PKT_COLS]

        def _flush():
            out = {k: np.asarray(c, dtype=STREAM_DTYPES[k])
                   for k, c in zip(PKT_COLS, cols)}
            for c in cols:
                c.clear()
            return out

        while True:
            rh = f.read(16)
            if not rh:
                break
            if len(rh) < 16:
                raise TraceFormatError(
                    f"truncated pcap record header at offset {offset}: "
                    f"got {len(rh)} of 16 bytes")
            sec, frac, incl, _orig = rec_hdr.unpack(rh)
            offset += 16
            body = f.read(incl)
            if len(body) < incl:
                raise TraceFormatError(
                    f"truncated pcap record body at offset {offset}: "
                    f"expected {incl} bytes, got {len(body)}")
            offset += incl
            ts_us = sec * 1_000_000 + (frac // 1000 if nanos else frac)
            if ts_base is None:
                # epoch-stamped captures rebase to their first record so
                # timestamps fit the drivers' int32 microsecond clock;
                # synthetic fixtures (already < 2^31-1) pass through
                ts_base = ts_us if ts_us > _TS_MOD else 0
            parsed = _parse_frame(body, linktype)
            if parsed is None:
                stats["skipped"] += 1
                continue
            cols[0].append((ts_us - ts_base) % _TS_MOD)
            for col, v in zip(cols[1:], parsed):
                col.append(v)
            if len(cols[0]) >= chunk_pkts:
                yield _flush()
        if cols[0]:
            yield _flush()
    finally:
        if should_close:
            f.close()


# ---------------------------------------------------------------------------
# flow bookkeeping (flow_idx / flow_pos / label)
# ---------------------------------------------------------------------------


class _FlowTable:
    """First-seen flow numbering + per-flow packet positions, carried
    across chunks.  A labels sidecar pre-assigns (flow_id, label) per
    5-tuple — ids from the sidecar are authoritative, so ingesting a
    ``synthesize_pcap`` fixture reproduces the source stream's ``flow_idx``
    exactly; unseen 5-tuples get fresh ids after the sidecar's range."""

    def __init__(self, sidecar: Optional[Mapping] = None):
        self.ids: Dict[Tuple, int] = {}
        self.labels: Dict[int, int] = {}
        self.pos: Dict[int, int] = {}
        self.next_id = 0
        if sidecar:
            for ft_key, (fid, label) in sidecar.items():
                self.ids[ft_key] = fid
                self.labels[fid] = label
            self.next_id = max(self.labels) + 1

    def assign(self, chunk: Dict[str, np.ndarray]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if len(chunk["ts_us"]) == 0:
            z = np.zeros(0, np.int32)
            return z, z.copy(), z.copy()
        keys = np.stack([chunk[k].astype(np.int64) for k in
                         ("src_ip", "dst_ip", "src_port", "dst_port",
                          "proto")], axis=1)
        uniq, first, inv = np.unique(keys, axis=0, return_index=True,
                                     return_inverse=True)
        inv = inv.reshape(-1)
        fid_of_uniq = np.empty(len(uniq), np.int64)
        # visit uniques in first-seen order so id assignment is invariant
        # to chunk size (np.unique itself sorts lexicographically)
        for u in np.argsort(first, kind="stable"):
            key = tuple(int(x) for x in uniq[u])
            fid = self.ids.get(key)
            if fid is None:
                fid = self.ids[key] = self.next_id
                self.labels.setdefault(fid, -1)
                self.next_id += 1
            fid_of_uniq[u] = fid
        fids = fid_of_uniq[inv]
        # running per-flow packet position: rank within the chunk (stable
        # grouping) + the base carried from earlier chunks
        order = np.argsort(inv, kind="stable")
        ranks = np.empty(len(inv), np.int64)
        grouped = inv[order]
        starts = np.concatenate([[0], np.flatnonzero(
            np.diff(grouped)) + 1]) if len(inv) else np.zeros(0, np.int64)
        ranks[order] = np.arange(len(inv)) - np.repeat(
            starts, np.diff(np.concatenate([starts, [len(inv)]])))
        base = np.asarray([self.pos.get(int(fid), 0)
                           for fid in fid_of_uniq], np.int64)
        pos = ranks + base[inv]
        counts = np.bincount(inv, minlength=len(uniq))
        for u, fid in enumerate(fid_of_uniq):
            self.pos[int(fid)] = int(base[u] + counts[u])
        labels = np.asarray([self.labels.get(int(fid), -1)
                             for fid in fid_of_uniq], np.int64)[inv]
        return (fids.astype(np.int32), pos.astype(np.int32),
                labels.astype(np.int32))


def read_flow_labels(source) -> Dict[Tuple, Tuple[int, int]]:
    """Read a per-flow ground-truth sidecar CSV:
    ``flow_id,src_ip,dst_ip,src_port,dst_port,proto,label`` ->
    {5-tuple: (flow_id, label)}."""
    f, should_close = (source, False) if hasattr(source, "read") else \
        (open(os.fspath(source), "r", newline=""), True)
    try:
        out: Dict[Tuple, Tuple[int, int]] = {}
        for row in csv.DictReader(f):
            key = (tf.parse_ip(row["src_ip"]), tf.parse_ip(row["dst_ip"]),
                   int(row["src_port"]), int(row["dst_port"]),
                   tf.parse_proto(row["proto"]))
            out[key] = (int(row["flow_id"]), int(row["label"]))
        return out
    finally:
        if should_close:
            f.close()


def write_flow_labels(flows: List[Flow], path) -> None:
    """Write the ground-truth sidecar ``synthesize_pcap`` pairs with its
    capture (one row per flow, ids = positions in ``flows``)."""
    with open(os.fspath(path), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["flow_id", "src_ip", "dst_ip", "src_port", "dst_port",
                    "proto", "label"])
        for i, fl in enumerate(flows):
            w.writerow([i] + [int(x) for x in fl.five_tuple]
                       + [int(fl.label)])


def sidecar_path(pcap_path) -> str:
    """Conventional location of a capture's label sidecar."""
    return os.fspath(pcap_path) + ".labels.csv"


# ---------------------------------------------------------------------------
# whole-capture ingestion
# ---------------------------------------------------------------------------


def ingest_pcap(source, labels: Union[None, str, Mapping] = "auto",
                limit: Optional[int] = None, chunk_pkts: int = 65536,
                stats: Optional[Dict[str, int]] = None
                ) -> Dict[str, np.ndarray]:
    """pcap -> full packet_stream dict (all 10 columns).

    ``labels``: a sidecar CSV path, a pre-read mapping, ``"auto"`` (use
    ``<pcap>.labels.csv`` when present), or None.  Without a sidecar, flows
    are numbered in first-seen order and labeled -1.  ``limit`` truncates
    after that many packets without reading the rest of the capture.
    """
    if labels == "auto":
        cand = sidecar_path(source) if not hasattr(source, "read") else None
        labels = cand if cand and os.path.exists(cand) else None
    if isinstance(labels, (str, os.PathLike)):
        labels = read_flow_labels(labels)
    table = _FlowTable(labels)
    parts: List[Dict[str, np.ndarray]] = []
    kept = 0
    for chunk in iter_pcap_packets(source, chunk_pkts=chunk_pkts,
                                   stats=stats):
        if limit is not None and kept + len(chunk["ts_us"]) > limit:
            chunk = {k: v[:limit - kept] for k, v in chunk.items()}
        fid, pos, lab = table.assign(chunk)
        chunk["flow_idx"], chunk["flow_pos"] = fid, pos
        chunk["label"] = lab
        parts.append(chunk)
        kept += len(chunk["ts_us"])
        if limit is not None and kept >= limit:
            break
    if not parts:
        return {k: np.zeros(0, dt) for k, dt in STREAM_DTYPES.items()}
    return {k: np.concatenate([p[k] for p in parts])
            for k in STREAM_DTYPES}


def flows_from_stream(stream: Dict[str, np.ndarray]) -> List[Flow]:
    """Regroup a packet_stream into per-flow ``Flow`` objects (the layout
    ``windows_from_flows`` / the baselines train on).

    One global sort on (flow_idx, flow_pos) then contiguous splits —
    O(n log n), so corpus-scale captures (100k flows, millions of
    packets) regroup in one pass instead of one full scan per flow.
    """
    fids = np.asarray(stream["flow_idx"], np.int64)
    pos = np.asarray(stream["flow_pos"], np.int64)
    order = np.lexsort((pos, fids))
    fids_s = fids[order]
    ts_s = np.asarray(stream["ts_us"], np.int64)[order]
    len_s = np.asarray(stream["pkt_len"])[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(fids_s)) + 1,
                             [len(fids_s)]]) if len(fids_s) else \
        np.zeros(1, np.int64)
    flows: List[Flow] = []
    for lo, hi in zip(starts[:-1], starts[1:]):
        ts = ts_s[lo:hi]
        ipd = np.zeros(hi - lo, np.int64)
        ipd[1:] = np.diff(ts)
        i = order[lo]
        ft = tuple(int(stream[k][i]) for k in
                   ("src_ip", "dst_ip", "src_port", "dst_port", "proto"))
        flows.append(Flow(
            label=int(stream["label"][i]), five_tuple=ft,
            start_us=int(ts[0]),
            pkt_len=len_s[lo:hi].astype(np.int32),
            ipd_us=np.clip(ipd, 0, 2**31 - 1).astype(np.int32)))
    return flows


# ---------------------------------------------------------------------------
# pcap writing / fixture synthesis
# ---------------------------------------------------------------------------


def _ip_checksum(hdr: bytes) -> int:
    s = sum(int.from_bytes(hdr[i:i + 2], "big")
            for i in range(0, len(hdr), 2))
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def write_pcap(stream: Dict[str, np.ndarray], path, nanos: bool = False,
               byteorder: str = "<") -> int:
    """Write a packet_stream out as classic pcap (Ethernet/IPv4/TCP|UDP).

    Only headers are materialized per packet; the IP total-length field
    carries ``pkt_len`` and the record's orig_len is the full frame size,
    so ingestion recovers the stream exactly (snaplen-truncated captures,
    like tcpdump -s).  Protocols other than TCP/UDP are written without an
    L4 header (their ports cannot survive a real capture).  Returns the
    number of records written.
    """
    magic = PCAP_MAGIC_NS if nanos else PCAP_MAGIC_US
    rec_hdr = struct.Struct(byteorder + "IIII")
    eth = b"\x02\x00\x00\x00\x00\x01\x02\x00\x00\x00\x00\x02\x08\x00"
    n = len(stream["ts_us"])
    frac_mul = 1000 if nanos else 1
    buf: List[bytes] = []
    with open(os.fspath(path), "wb") as f:
        f.write(struct.pack(byteorder + "IHHiIII", magic, 2, 4, 0, 0, 96,
                            LINKTYPE_ETHERNET))
        for i in range(n):
            proto = int(stream["proto"][i])
            sport, dport = int(stream["src_port"][i]), \
                int(stream["dst_port"][i])
            if proto == 6:
                l4 = struct.pack(">HHIIBBHHH", sport, dport, 0, 0, 5 << 4,
                                 0x10, 8192, 0, 0)
            elif proto == 17:
                pkt_len = int(stream["pkt_len"][i])
                l4 = struct.pack(">HHHH", sport, dport,
                                 max(pkt_len - 20, 8) & 0xFFFF, 0)
            else:
                l4 = b""
            total_len = int(stream["pkt_len"][i]) & 0xFFFF
            ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, total_len,
                             i & 0xFFFF, 0, 64, proto, 0,
                             int(stream["src_ip"][i]).to_bytes(4, "big"),
                             int(stream["dst_ip"][i]).to_bytes(4, "big"))
            ip = ip[:10] + _ip_checksum(ip).to_bytes(2, "big") + ip[12:]
            frame = eth + ip + l4
            ts = int(stream["ts_us"][i])
            orig = 14 + max(total_len, len(frame) - 14)
            buf.append(rec_hdr.pack(ts // 1_000_000,
                                    (ts % 1_000_000) * frac_mul,
                                    len(frame), orig))
            buf.append(frame)
            if len(buf) >= 8192:
                f.write(b"".join(buf))
                buf.clear()
        f.write(b"".join(buf))
    return n


def synthesize_pcap(flows: List[Flow], pcap_path,
                    labels_path: Union[None, str, os.PathLike] = "auto",
                    limit: Optional[int] = None,
                    nanos: bool = False) -> Dict[str, np.ndarray]:
    """Write synthetic flows out as real pcap bytes + a label sidecar.

    Deterministic: the same flows always produce the same file (IP ids are
    sequence numbers, no randomness), which is what lets CI cache fixtures
    keyed on a source hash.  Returns the interleaved source stream — the
    oracle that ``ingest_pcap(pcap_path)`` must reproduce bit-for-bit.
    """
    seen: Dict[Tuple, int] = {}
    for i, fl in enumerate(flows):
        key = tuple(int(x) for x in fl.five_tuple)
        if key[4] not in (6, 17) and (key[2] or key[3]):
            # the wire format cannot carry ports without an L4 header, so
            # ingest could never match this flow against the sidecar —
            # reject now instead of silently corrupting flow_idx/label
            raise TraceFormatError(
                f"flow {i} has protocol {key[4]} with nonzero ports "
                f"{key[2]}/{key[3]}; a pcap only carries ports for "
                f"TCP(6)/UDP(17) — zero them or switch protocol")
        if key in seen:
            raise TraceFormatError(
                f"flows {seen[key]} and {i} share 5-tuple {key}; a pcap "
                f"cannot distinguish them — regenerate with another seed")
        seen[key] = i
    stream = packet_stream(flows, limit=limit)
    write_pcap(stream, pcap_path, nanos=nanos)
    if labels_path == "auto":
        labels_path = sidecar_path(pcap_path)
    if labels_path is not None:
        write_flow_labels(flows, labels_path)
    return stream


def write_generic_csv(stream: Dict[str, np.ndarray], path) -> None:
    """Write a packet_stream as a generic packet-level 5-tuple CSV (the
    ``generic`` adapter's layout, with flow_id + numeric label columns)."""
    with open(os.fspath(path), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ts_us", "src_ip", "dst_ip", "src_port", "dst_port",
                    "proto", "pkt_len", "label", "flow_id"])
        for i in range(len(stream["ts_us"])):
            w.writerow([int(stream[k][i]) for k in
                        ("ts_us", "src_ip", "dst_ip", "src_port",
                         "dst_port", "proto", "pkt_len", "label",
                         "flow_idx")])


# ---------------------------------------------------------------------------
# front door: path -> stream / flows
# ---------------------------------------------------------------------------


def _looks_like_pcap(path) -> bool:
    p = os.fspath(path)
    if p.endswith((".pcap", ".cap", ".dump")):
        return True
    if p.endswith(".csv"):
        return False
    try:
        with open(p, "rb") as f:
            head = f.read(4)
    except OSError:
        return False
    # both magics, either byte order
    return len(head) == 4 and struct.unpack("<I", head)[0] in (
        0xA1B2C3D4, 0xA1B23C4D, 0xD4C3B2A1, 0x4D3CB2A1)


def load_stream(source, adapter: Union[None, str, tf.CsvSchema] = None,
                labels: Union[None, str, Mapping] = "auto",
                limit: Optional[int] = None,
                chunk_pkts: int = 65536) -> Dict[str, np.ndarray]:
    """One-call trace loader: capture path (pcap or CSV) -> packet_stream.

    This is the ``source=`` selector the drivers and benchmarks thread
    through: pcaps go through the streaming record parser (with an optional
    ground-truth sidecar), CSVs through the ``adapter`` schema (default
    ``generic``) and ``packet_stream`` interleaving.  A dict passes through
    untouched so call sites can accept either form.
    """
    if isinstance(source, dict):
        return source
    if hasattr(source, "read") or _looks_like_pcap(source):
        # file-like sources stream straight through the pcap reader,
        # matching ingest_pcap/iter_pcap_packets
        return ingest_pcap(source, labels=labels, limit=limit,
                           chunk_pkts=chunk_pkts)
    flows = tf.flows_from_csv(source, adapter or "generic")
    return packet_stream(flows, limit=limit)


def load_flows(source, adapter: Union[None, str, tf.CsvSchema] = None,
               labels: Union[None, str, Mapping] = "auto",
               limit: Optional[int] = None) -> List[Flow]:
    """Capture path -> per-flow ``Flow`` list (for training/baselines)."""
    if hasattr(source, "read") or _looks_like_pcap(source):
        return flows_from_stream(ingest_pcap(source, labels=labels,
                                             limit=limit))
    return tf.flows_from_csv(source, adapter or "generic")


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Declarative trace handle for ``FenixSystem.run_trace(trace=...)``.

    Bundles a capture source with its ingestion options — the single
    replacement for the deprecated ``run_trace(source=, adapter=,
    trace_labels=, limit=)`` keyword pile.  ``load()`` materializes the
    full packet stream (what the host/pipes/farm drivers and training
    consume); ``iter_chunks()`` streams it in bounded column chunks,
    which is what the device driver's double-buffered ingest pipelines
    against the compiled scan.
    """
    # capture path (pcap or CSV), open binary file object, or an
    # already-parsed packet-stream dict (degenerate parse-free streaming)
    source: object
    # CSV schema name / CsvSchema (ignored for pcaps); default "generic"
    adapter: Union[None, str, "tf.CsvSchema"] = None
    # pcap ground-truth sidecar: path, mapping, "auto" (the
    # <pcap>.labels.csv convention), or None.  Only load() consumes it —
    # the data plane's 7 packet columns carry no labels.
    labels: Union[None, str, Mapping] = "auto"
    # truncate after this many packets without reading the rest
    limit: Optional[int] = None
    # packets per parsed chunk (streaming granularity and memory bound)
    chunk_pkts: int = 65536
    # let run_trace double-buffer: parse + device staging of chunk k+1 in
    # a background thread while the device scans chunk k.  False forces
    # synchronous staging (the bench_soak comparison baseline).
    overlap: bool = True

    def load(self) -> Dict[str, np.ndarray]:
        """Materialize the whole capture as one packet_stream dict."""
        return load_stream(self.source, adapter=self.adapter,
                           labels=self.labels, limit=self.limit,
                           chunk_pkts=self.chunk_pkts)

    def iter_chunks(self) -> Iterator[Dict[str, np.ndarray]]:
        """Stream the capture as column-dict chunks of at most
        ``chunk_pkts`` packets, honoring ``limit``.

        pcap sources stream incrementally (captures larger than host
        memory work); CSV and dict sources load once and slice — the
        chunking still lets the consumer overlap staging with compute.
        """
        streamable = not isinstance(self.source, dict) and (
            hasattr(self.source, "read") or _looks_like_pcap(self.source))
        if streamable:
            kept = 0
            for chunk in iter_pcap_packets(self.source,
                                           chunk_pkts=self.chunk_pkts):
                if self.limit is not None and \
                        kept + len(chunk["ts_us"]) > self.limit:
                    chunk = {k: v[:self.limit - kept]
                             for k, v in chunk.items()}
                if len(chunk["ts_us"]):
                    yield chunk
                kept += len(chunk["ts_us"])
                if self.limit is not None and kept >= self.limit:
                    return
            return
        stream = (self.source if isinstance(self.source, dict)
                  else self.load())
        n = len(stream["ts_us"])
        if self.limit is not None:
            n = min(n, self.limit)
        for lo in range(0, n, self.chunk_pkts):
            yield {k: np.asarray(v)[lo:min(lo + self.chunk_pkts, n)]
                   for k, v in stream.items()}
