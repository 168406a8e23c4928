"""Per-dataset schema adapters: real trace exports -> the repro's ``Flow``s.

The paper evaluates on ISCXVPN2016 and USTC-TFC (Table 1/2); both corpora
ship as raw pcaps plus flow-level CSV exports (CICFlowMeter-style for ISCX,
flow summaries for USTC).  This module normalizes those CSV layouts — and a
generic packet-level 5-tuple CSV — into the exact
:class:`repro_torch.data.synthetic_traffic.Flow` objects the rest of
the port
consumes, with labels mapped onto ``ISCX_CLASSES`` / ``USTC_CLASSES``.

Raw pcap parsing lives in :mod:`repro_torch.data.trace_ingest`; this
module owns
everything schema-shaped: column aliasing, label vocabularies, IP/proto/
timestamp coercion, and the deterministic flow-level -> packet-level
reconstruction (flow rows only carry aggregates, so packets are laid out
evenly across the reported duration/byte budget — no randomness, so runs
are reproducible).

The port's own copy of ``repro/data/trace_formats.py`` (numpy and the
standard library only): the same adapters, error types and messages.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime
import io
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.data.synthetic_traffic import Flow, ISCX_CLASSES, USTC_CLASSES


class TraceFormatError(ValueError):
    """Malformed trace input: bad pcap magic, truncated record, unknown
    CSV column or label — always with a message saying what was expected."""


# ---------------------------------------------------------------------------
# field coercion helpers
# ---------------------------------------------------------------------------

_PROTO_NAMES = {"tcp": 6, "udp": 17, "icmp": 1, "igmp": 2, "gre": 47,
                "esp": 50, "sctp": 132}


def parse_ip(raw: Union[str, int]) -> int:
    """Dotted-quad or plain-integer IPv4 address -> uint32 host int."""
    if isinstance(raw, (int, np.integer)):
        return int(raw) & 0xFFFFFFFF
    s = str(raw).strip()
    if "." in s:
        parts = s.split(".")
        if len(parts) != 4:
            raise TraceFormatError(f"bad IPv4 address {raw!r}")
        try:
            octets = [int(p) for p in parts]
        except ValueError as e:
            raise TraceFormatError(f"bad IPv4 address {raw!r}") from e
        if any(o < 0 or o > 255 for o in octets):
            raise TraceFormatError(f"bad IPv4 address {raw!r}")
        return (octets[0] << 24) | (octets[1] << 16) \
            | (octets[2] << 8) | octets[3]
    try:
        return int(float(s)) & 0xFFFFFFFF
    except ValueError as e:
        raise TraceFormatError(f"bad IPv4 address {raw!r}") from e


def parse_proto(raw: Union[str, int]) -> int:
    """IANA protocol number or name ("tcp"/"udp"/...) -> int."""
    if isinstance(raw, (int, np.integer)):
        return int(raw)
    s = str(raw).strip().lower()
    if s in _PROTO_NAMES:
        return _PROTO_NAMES[s]
    try:
        return int(float(s))
    except ValueError as e:
        raise TraceFormatError(
            f"bad protocol {raw!r} (want a number or one of "
            f"{sorted(_PROTO_NAMES)})") from e


def parse_time_us(raw: Union[str, float, int], unit_us: float) -> int:
    """Numeric timestamp (x ``unit_us`` -> microseconds) or ISO datetime."""
    if isinstance(raw, (int, float, np.integer, np.floating)):
        return int(round(float(raw) * unit_us))
    s = str(raw).strip()
    try:
        return int(round(float(s) * unit_us))
    except ValueError:
        pass
    try:
        dt = datetime.datetime.fromisoformat(s)
    except ValueError as e:
        raise TraceFormatError(
            f"bad timestamp {raw!r} (want a number or ISO datetime)") from e
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return int(round(dt.timestamp() * 1e6))


def _norm(name: str) -> str:
    """Normalize a CSV header / label for matching: lower-case, spaces and
    underscores folded to single dashes."""
    out = "".join(c if c.isalnum() else "-" for c in str(name).lower())
    while "--" in out:
        out = out.replace("--", "-")
    return out.strip("-")


# ---------------------------------------------------------------------------
# schemas
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CsvSchema:
    """One dataset's CSV layout.

    ``level`` is "packet" (one row per packet) or "flow" (one row per flow,
    aggregates only).  ``columns`` maps canonical field names to accepted
    header spellings (matched after :func:`_norm`).  ``label_aliases`` maps
    normalized raw labels to canonical class names from ``classes``.
    """

    name: str
    level: str
    classes: Tuple[str, ...]
    columns: Mapping[str, Tuple[str, ...]]
    label_aliases: Mapping[str, str]
    time_unit_us: float = 1.0       # timestamps column -> microseconds
    duration_unit_us: float = 1.0   # duration column -> microseconds


_GENERIC_COLUMNS = {
    "ts": ("ts-us", "ts", "timestamp", "time"),
    "src_ip": ("src-ip", "source-ip", "saddr", "ip-src"),
    "dst_ip": ("dst-ip", "destination-ip", "daddr", "ip-dst"),
    "src_port": ("src-port", "source-port", "sport"),
    "dst_port": ("dst-port", "destination-port", "dport"),
    "proto": ("proto", "protocol"),
    "pkt_len": ("pkt-len", "packet-length", "length", "len", "frame-len"),
    "label": ("label", "class", "app"),
    "flow_id": ("flow-id", "flow-idx", "flow"),
}

_ISCX_ALIASES = {
    "chat": "chat", "aim": "chat", "icq": "chat", "facebook-chat": "chat",
    "hangouts-chat": "chat", "skype-chat": "chat",
    "email": "email", "smtp": "email", "pop3": "email", "imap": "email",
    "gmail": "email",
    "file": "file", "file-transfer": "file", "ft": "file", "ftps": "file",
    "sftp": "file", "scp": "file", "skype-file": "file",
    "p2p": "p2p", "torrent": "p2p", "bittorrent": "p2p", "utorrent": "p2p",
    "stream": "stream", "streaming": "stream", "youtube": "stream",
    "netflix": "stream", "vimeo": "stream", "spotify": "stream",
    "voip": "voip", "skype-audio": "voip", "voipbuster": "voip",
    "hangouts-audio": "voip",
    "web": "web", "browsing": "web", "http": "web", "https": "web",
}

_USTC_ALIASES = {
    "cridex": "cridex",
    "ftp": "ftp",
    "geodo": "geodo", "emotet": "geodo",
    "htbot": "htbot",
    "neris": "neris",
    "nsis-ay": "nsis-ay", "nsis": "nsis-ay",
    "warcraft": "warcraft", "world-of-warcraft": "warcraft",
    "wow": "warcraft",
    "zeus": "zeus",
    "virut": "virut",
    "weibo": "weibo",
    "shifu": "shifu",
    "smb": "smb",
}

GENERIC = CsvSchema(
    name="generic",
    level="packet",
    classes=ISCX_CLASSES,
    columns=_GENERIC_COLUMNS,
    label_aliases=_ISCX_ALIASES,
)

ISCX_VPN = CsvSchema(
    name="iscx_vpn",
    level="flow",
    classes=ISCX_CLASSES,
    columns={
        "src_ip": ("src-ip", "source-ip"),
        "src_port": ("src-port", "source-port"),
        "dst_ip": ("dst-ip", "destination-ip"),
        "dst_port": ("dst-port", "destination-port"),
        "proto": ("protocol", "proto"),
        "start": ("timestamp", "flow-start-time", "start"),
        "duration": ("flow-duration", "duration"),
        "packets": ("total-fwd-packets", "tot-fwd-pkts", "total-packets",
                    "packets"),
        "bytes": ("total-length-of-fwd-packets", "totlen-fwd-pkts",
                  "total-bytes", "bytes"),
        "label": ("label", "class"),
    },
    label_aliases=_ISCX_ALIASES,
    time_unit_us=1e6,       # CICFlowMeter timestamps are in seconds
    duration_unit_us=1.0,   # Flow Duration is already microseconds
)

USTC_TFC = CsvSchema(
    name="ustc_tfc",
    level="flow",
    classes=USTC_CLASSES,
    columns={
        "src_ip": ("src-ip", "sa", "srcip"),
        "src_port": ("sport", "src-port"),
        "dst_ip": ("dst-ip", "da", "dstip"),
        "dst_port": ("dport", "dst-port"),
        "proto": ("protocol", "proto"),
        "start": ("first-seen", "start-time", "ts"),
        "duration": ("duration-ms", "duration"),
        "packets": ("pkt-count", "packets", "num-pkts"),
        "bytes": ("byte-count", "bytes"),
        "label": ("app", "label", "family"),
    },
    label_aliases=_USTC_ALIASES,
    time_unit_us=1e3,       # first_seen in milliseconds
    duration_unit_us=1e3,   # duration in milliseconds
)

ADAPTERS: Dict[str, CsvSchema] = {
    "generic": GENERIC,
    "iscx_vpn": ISCX_VPN,
    "ustc_tfc": USTC_TFC,
}


def get_adapter(name: Union[str, CsvSchema]) -> CsvSchema:
    if isinstance(name, CsvSchema):
        return name
    try:
        return ADAPTERS[name]
    except KeyError:
        raise TraceFormatError(
            f"unknown trace adapter {name!r}; valid adapters: "
            f"{', '.join(sorted(ADAPTERS))}") from None


def map_label(raw: Union[str, int], schema: CsvSchema,
              strict: bool = True) -> int:
    """Raw dataset label -> class index in ``schema.classes``.

    Accepts numeric class indices, canonical class names, any alias in
    ``schema.label_aliases``, and "vpn-" prefixed variants of either.
    Unknown labels raise :class:`TraceFormatError` (or return -1 when
    ``strict`` is false).
    """
    if isinstance(raw, (int, np.integer)) or \
            (isinstance(raw, str) and raw.strip().lstrip("-").isdigit()):
        # numeric labels are already class indices (dataset-encoded);
        # range-checking them against a task is the caller's business
        idx = int(raw)
        if idx >= -1:
            return idx
        if not strict:
            return -1
        raise TraceFormatError(
            f"bad numeric label {idx} for {schema.name} (want >= -1)")
    key = _norm(raw)
    for k in (key, key[4:] if key.startswith("vpn-") else key):
        name = schema.label_aliases.get(k, k)
        if name in schema.classes:
            return schema.classes.index(name)
    if not strict:
        return -1
    raise TraceFormatError(
        f"unknown {schema.name} label {raw!r}; known labels: "
        f"{', '.join(sorted(set(schema.label_aliases)))}")


# ---------------------------------------------------------------------------
# CSV -> flows
# ---------------------------------------------------------------------------


def _resolve_columns(schema: CsvSchema, fieldnames: Sequence[str],
                     required: Sequence[str]) -> Dict[str, str]:
    have = {_norm(h): h for h in fieldnames if h is not None}
    out: Dict[str, str] = {}
    for field, candidates in schema.columns.items():
        for cand in candidates:
            if cand in have:
                out[field] = have[cand]
                break
    missing = [f for f in required if f not in out]
    if missing:
        raise TraceFormatError(
            f"{schema.name} CSV is missing column(s) {missing}; "
            f"have: {sorted(have)}")
    return out


def _five_tuple(row: Mapping[str, str],
                cols: Mapping[str, str]) -> Tuple[int, int, int, int, int]:
    return (parse_ip(row[cols["src_ip"]]), parse_ip(row[cols["dst_ip"]]),
            int(float(row[cols["src_port"]])),
            int(float(row[cols["dst_port"]])),
            parse_proto(row[cols["proto"]]))


def _flow_from_aggregates(ft: Tuple[int, int, int, int, int], label: int,
                          start_us: int, duration_us: int, n_pkts: int,
                          n_bytes: int) -> Flow:
    """Deterministic packet layout for a flow-level row: ``n_pkts`` packets
    spread evenly over ``duration_us`` carrying ``n_bytes`` total (lengths
    clipped to the feature pipeline's [40, 1500] plausible-IP range)."""
    n = max(1, int(n_pkts))
    base, rem = divmod(max(int(n_bytes), 0), n)
    lens = np.full(n, base, np.int64)
    lens[:rem] += 1
    lens = np.clip(lens, 40, 1500).astype(np.int32)
    ipd = np.zeros(n, np.int64)
    if n > 1:
        step, irem = divmod(max(int(duration_us), 0), n - 1)
        ipd[1:] = step
        ipd[1:1 + irem] += 1
    ipd = np.clip(ipd, 0, 2**31 - 1).astype(np.int32)
    return Flow(label=int(label), five_tuple=ft, start_us=int(start_us),
                pkt_len=lens, ipd_us=ipd)


def _open_text(source):
    if hasattr(source, "read"):
        return source, False
    return open(os.fspath(source), "r", newline=""), True


def flows_from_csv(source, schema: Union[str, CsvSchema] = "generic",
                   strict_labels: bool = True,
                   max_flows: Optional[int] = None) -> List[Flow]:
    """Parse a CSV export into ``Flow`` objects via a schema adapter.

    Packet-level schemas group rows into flows by the ``flow_id`` column
    when present, else by 5-tuple (first-seen order); flow-level schemas
    reconstruct a deterministic packet sequence from each row's aggregate
    packet/byte/duration columns.
    """
    schema = get_adapter(schema)
    f, should_close = _open_text(source)
    try:
        reader = csv.DictReader(f)
        if not reader.fieldnames:
            raise TraceFormatError(f"{schema.name} CSV is empty (no header)")
        if schema.level == "flow":
            return _read_flow_level(reader, schema, strict_labels, max_flows)
        return _read_packet_level(reader, schema, strict_labels, max_flows)
    finally:
        if should_close:
            f.close()


def _read_flow_level(reader, schema, strict_labels, max_flows):
    required = ("src_ip", "dst_ip", "src_port", "dst_port", "proto",
                "start", "duration", "packets", "bytes")
    cols = _resolve_columns(schema, reader.fieldnames, required)
    flows: List[Flow] = []
    for row in reader:
        if max_flows is not None and len(flows) >= max_flows:
            break
        label = -1
        if "label" in cols and row.get(cols["label"]) not in (None, ""):
            label = map_label(row[cols["label"]], schema,
                              strict=strict_labels)
        flows.append(_flow_from_aggregates(
            _five_tuple(row, cols), label,
            parse_time_us(row[cols["start"]], schema.time_unit_us),
            int(round(float(row[cols["duration"]])
                      * schema.duration_unit_us)),
            int(float(row[cols["packets"]])),
            int(float(row[cols["bytes"]]))))
    return flows


def _read_packet_level(reader, schema, strict_labels, max_flows):
    required = ("ts", "src_ip", "dst_ip", "src_port", "dst_port", "proto",
                "pkt_len")
    cols = _resolve_columns(schema, reader.fieldnames, required)
    by_flow: Dict[object, Dict] = {}
    for row in reader:
        ft = _five_tuple(row, cols)
        if "flow_id" in cols and row.get(cols["flow_id"]) not in (None, ""):
            key: object = int(float(row[cols["flow_id"]]))
        else:
            key = ft
        rec = by_flow.get(key)
        if rec is None:
            if max_flows is not None and len(by_flow) >= max_flows:
                continue
            rec = by_flow[key] = {"ft": ft, "ts": [], "len": [],
                                  "label": -1}
        rec["ts"].append(parse_time_us(row[cols["ts"]],
                                       schema.time_unit_us))
        rec["len"].append(int(float(row[cols["pkt_len"]])))
        if rec["label"] < 0 and "label" in cols and \
                row.get(cols["label"]) not in (None, ""):
            rec["label"] = map_label(row[cols["label"]], schema,
                                     strict=strict_labels)
    flows: List[Flow] = []
    keys = sorted(by_flow) if all(
        isinstance(k, int) for k in by_flow) else list(by_flow)
    for key in keys:
        rec = by_flow[key]
        order = np.argsort(np.asarray(rec["ts"], np.int64), kind="stable")
        ts = np.asarray(rec["ts"], np.int64)[order]
        lens = np.asarray(rec["len"], np.int64)[order]
        ipd = np.zeros(len(ts), np.int64)
        ipd[1:] = np.diff(ts)
        flows.append(Flow(
            label=int(rec["label"]), five_tuple=rec["ft"],
            start_us=int(ts[0]),
            pkt_len=lens.astype(np.int32),
            ipd_us=np.clip(ipd, 0, 2**31 - 1).astype(np.int32)))
    return flows


def flows_from_csv_text(text: str, schema: Union[str, CsvSchema] = "generic",
                        **kw) -> List[Flow]:
    """Convenience wrapper: parse CSV content given as a string."""
    return flows_from_csv(io.StringIO(text), schema, **kw)
