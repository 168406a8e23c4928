"""Capture replay in the port: ``trace_ingest`` / ``trace_formats`` (the
port's own copies) write the reference's pcap bytes and ingest captures
and CSV exports to the reference's columns, with the same errors; and
``FenixSystem.run_trace`` on a capture path or a ``TraceSpec`` streams
on the device driver (overlapped and in line) to the verdicts, stats and
carry of the in-memory replay and of the reference's streaming replay.
"""

import io
import os
import struct
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import assert_same  # noqa: E402
from repro.configs.fenix_models import fenix_rnn_tiny  # noqa: E402
from repro.core.fenix import FenixConfig as JFenixConfig  # noqa: E402
from repro.core.fenix import FenixSystem as JFenixSystem  # noqa: E402
from repro.core.model_engine.inference import (  # noqa: E402
    ByLenModel as JByLenModel, EngineModel as JEngineModel)
from repro.data import synthetic_traffic as jst  # noqa: E402
from repro.data import trace_formats as jtf  # noqa: E402
from repro.data import trace_ingest as jti  # noqa: E402
from repro.models import traffic as jtraffic  # noqa: E402
from repro.quant.quantize import quantize_traffic  # noqa: E402
from repro_torch.configs.fenix_models import (  # noqa: E402
    fenix_rnn_tiny as t_fenix_rnn_tiny)
from repro_torch.core.fenix import FenixConfig, FenixSystem  # noqa: E402
from repro_torch.core.model_engine.inference import (  # noqa: E402
    ByLenModel, EngineModel)
from repro_torch.core.model_engine.serving import (  # noqa: E402
    qparams_from_numpy)
from repro_torch.data import synthetic_traffic as tst  # noqa: E402
from repro_torch.data import trace_formats as ttf  # noqa: E402
from repro_torch.data import trace_ingest as tti  # noqa: E402

# batch 128, cpe 2: a streamed block is 2 x 4 = 8 chunks (1024 packets),
# so 2500 packets make two full blocks, a short block of three chunks
# and a ragged tail of 68
BATCH, CPE, LIMIT = 128, 2, 2500


@pytest.fixture(scope="module")
def flows():
    return jst.make_flows("iscx", 40, seed=7)


@pytest.fixture(scope="module")
def capture(flows, tmp_path_factory):
    """A pcap of the flows with its label sidecar, and its source
    stream (written by the reference)."""
    pcap = tmp_path_factory.mktemp("cap") / "t.pcap"
    stream = jti.synthesize_pcap(flows, pcap, limit=LIMIT)
    return pcap, stream


def _same_columns(ref, port, where=""):
    assert sorted(port) == sorted(ref), where
    for k in ref:
        assert port[k].dtype == ref[k].dtype, (where, k)
        assert np.array_equal(port[k], ref[k]), (where, k)


# -- writing and ingesting captures --------------------------------------


@pytest.mark.parametrize("nanos,byteorder", [(False, "<"), (True, "<"),
                                             (False, ">"), (True, ">")])
def test_write_pcap_bytes_and_ingest_match_reference(flows, tmp_path,
                                                     nanos, byteorder):
    """The same bytes for microsecond/nanosecond magics in either byte
    order; each ingester reads either file to the same columns."""
    stream = jst.packet_stream(flows, limit=900)
    files = {}
    for who, mod in (("ref", jti), ("port", tti)):
        files[who] = tmp_path / f"{who}.pcap"
        assert mod.write_pcap(stream, files[who], nanos=nanos,
                              byteorder=byteorder) == 900
    assert files["ref"].read_bytes() == files["port"].read_bytes()
    ref = jti.ingest_pcap(files["port"], labels=None)
    port = tti.ingest_pcap(files["ref"], labels=None)
    _same_columns(ref, port)
    for k in tti.PKT_COLS:
        assert np.array_equal(port[k], stream[k]), k


@pytest.mark.parametrize("nanos", [False, True])
def test_synthesize_pcap_matches_reference(flows, tmp_path, nanos):
    """synthesize_pcap: the same pcap and sidecar bytes and the same
    source stream; ingest with the sidecar reproduces it (the oracle)."""
    out = {}
    for who, mod in (("ref", jst), ("port", tst)):
        fl = mod.make_flows("iscx", 40, seed=7)
        ing = jti if who == "ref" else tti
        out[who] = ing.synthesize_pcap(fl, tmp_path / f"{who}.pcap",
                                       limit=LIMIT, nanos=nanos)
    _same_columns(out["ref"], out["port"])
    for suffix in (".pcap", ".pcap.labels.csv"):
        assert (tmp_path / f"ref{suffix}").read_bytes() == \
            (tmp_path / f"port{suffix}").read_bytes(), suffix
    _same_columns(out["ref"], tti.ingest_pcap(tmp_path / "port.pcap"))
    _same_columns(jti.ingest_pcap(tmp_path / "ref.pcap", chunk_pkts=77),
                  tti.ingest_pcap(tmp_path / "ref.pcap", chunk_pkts=77))
    _same_columns(jti.ingest_pcap(tmp_path / "ref.pcap", labels=None,
                                  limit=333),
                  tti.ingest_pcap(tmp_path / "ref.pcap", labels=None,
                                  limit=333))


def _malformed(capture):
    raw = capture[0].read_bytes()
    return {
        "empty": b"",
        "bad magic": b"\xde\xad\xbe\xef" + b"\x00" * 20,
        "truncated global header": b"\xd4\xc3\xb2\xa1\x02\x00",
        "truncated record header": raw[:24 + 6],
        "truncated record body": raw[:24 + 16 + 9],
        "unsupported linktype": struct.pack(
            "<IHHiIII", tti.PCAP_MAGIC_US, 2, 4, 0, 0, 65535, 228),
    }


@pytest.mark.parametrize("case", ["empty", "bad magic",
                                  "truncated global header",
                                  "truncated record header",
                                  "truncated record body",
                                  "unsupported linktype"])
def test_malformed_captures_raise_the_reference_errors(capture, case):
    data = _malformed(capture)[case]
    errors = []
    for mod in (jti, tti):
        with pytest.raises(Exception) as e:
            mod.ingest_pcap(io.BytesIO(data), labels=None)
        errors.append(e.value)
    assert type(errors[1]).__name__ == type(errors[0]).__name__ == \
        "TraceFormatError"
    assert isinstance(errors[1], ttf.TraceFormatError)
    assert str(errors[1]) == str(errors[0])


def test_non_ip_frames_are_skipped_and_counted(capture):
    """Frames that are not IPv4 are skipped in both, and counted."""
    raw = capture[0].read_bytes()
    rec = struct.Struct("<IIII")
    arp = b"\xff" * 12 + b"\x08\x06" + b"\x00" * 28
    data = raw[:24] + rec.pack(0, 1, len(arp), len(arp)) + arp + raw[24:]
    stats = [{}, {}]
    ref = jti.ingest_pcap(io.BytesIO(data), labels=None, stats=stats[0])
    port = tti.ingest_pcap(io.BytesIO(data), labels=None, stats=stats[1])
    _same_columns(ref, port)
    assert stats[0] == stats[1] == {"skipped": 1}


def test_csv_adapters_match_reference(flows, tmp_path):
    """The generic packet CSV (written and read back), the two flow-level
    dataset exports, and their errors."""
    stream = jst.packet_stream(flows, limit=700)
    for who, mod in (("ref", jti), ("port", tti)):
        mod.write_generic_csv(stream, tmp_path / f"{who}.csv")
    assert (tmp_path / "ref.csv").read_bytes() == \
        (tmp_path / "port.csv").read_bytes()
    _same_columns(jti.load_stream(tmp_path / "ref.csv"),
                  tti.load_stream(tmp_path / "ref.csv"))
    iscx = (
        "Src IP,Src Port,Dst IP,Dst Port,Protocol,Timestamp,"
        "Flow Duration,Total Fwd Packets,"
        "Total Length of Fwd Packets,Label\n"
        "10.0.0.1,443,10.0.0.2,51000,TCP,12.5,2000000,10,14000,VPN-Chat\n"
        "192.168.1.5,5060,10.0.0.9,5061,UDP,13.0,5000000,50,8600,VoIP\n")
    ustc = ("sa,sport,da,dport,protocol,first_seen,duration_ms,"
            "pkt_count,byte_count,app\n"
            "1,1029,2,445,tcp,1000,2500,20,30000,SMB\n"
            "3,5555,4,80,tcp,1500,1200,8,1200,Neris\n")
    for text, adapter in ((iscx, "iscx_vpn"), (ustc, "ustc_tfc")):
        ref = jtf.flows_from_csv_text(text, adapter)
        port = ttf.flows_from_csv_text(text, adapter)
        assert len(ref) == len(port) == 2
        for a, b in zip(ref, port):
            assert (a.label, a.five_tuple, a.start_us) == \
                (b.label, b.five_tuple, b.start_us)
            assert np.array_equal(a.pkt_len, b.pkt_len)
            assert np.array_equal(a.ipd_us, b.ipd_us)
    for call in (lambda m: m.flows_from_csv_text("Src IP,Dst IP\n1,2\n",
                                                  "iscx_vpn"),
                 lambda m: m.get_adapter("netflow_v5"),
                 lambda m: m.map_label("quic-magic", m.ISCX_VPN)):
        msgs = []
        for mod in (jtf, ttf):
            with pytest.raises(mod.TraceFormatError) as e:
                call(mod)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_load_flows_and_flows_from_stream_match_reference(capture):
    pcap, stream = capture
    for ref, port in ((jti.load_flows(pcap), tti.load_flows(pcap)),
                      (jti.flows_from_stream(stream),
                       tti.flows_from_stream(stream))):
        assert len(ref) == len(port) > 0
        for a, b in zip(ref, port):
            assert (a.label, a.five_tuple, a.start_us) == \
                (b.label, b.five_tuple, b.start_us)
            assert np.array_equal(a.pkt_len, b.pkt_len)
            assert np.array_equal(a.ipd_us, b.ipd_us)
    _same_columns(jst.packet_stream(jti.flows_from_stream(stream)),
                  tst.packet_stream(tti.flows_from_stream(stream)))


@pytest.mark.parametrize("limit,chunk_pkts", [(None, 300), (1111, 128),
                                              (2000, 4096)])
def test_tracespec_iter_chunks_match_reference(capture, limit, chunk_pkts):
    """The same chunks from a pcap, a dict and a CSV source."""
    pcap, stream = capture
    for source in (pcap, dict(stream)):
        ref = list(jti.TraceSpec(source, limit=limit,
                                 chunk_pkts=chunk_pkts).iter_chunks())
        port = list(tti.TraceSpec(source, limit=limit,
                                  chunk_pkts=chunk_pkts).iter_chunks())
        kept = LIMIT if limit is None else limit
        assert len(ref) == len(port) == -(-kept // chunk_pkts)
        for a, b in zip(ref, port):
            _same_columns(a, b)
    spec = tti.TraceSpec(pcap, limit=limit, chunk_pkts=chunk_pkts)
    _same_columns(jti.TraceSpec(pcap, limit=limit).load(), spec.load())


# -- the streaming device driver --------------------------------------------


@pytest.fixture(scope="module")
def rnn_pair(flows):
    x, _, _ = jst.windows_from_flows(flows)
    qp = quantize_traffic(jtraffic.init(fenix_rnn_tiny(), seed=0),
                          fenix_rnn_tiny(), jnp.asarray(x[:128]))
    return JEngineModel(fenix_rnn_tiny(), qp), EngineModel(
        t_fenix_rnn_tiny(),
        qparams_from_numpy(jax.tree.map(np.asarray, qp), "cpu"))


def _pair(model_name, rnn_pair, driver="device", **kw):
    jmodel, tmodel = ((JByLenModel(), ByLenModel())
                      if model_name == "bylen" else rnn_pair)
    ref = JFenixSystem(JFenixConfig(batch_size=BATCH,
                                    control_plane_every=CPE, driver=driver),
                       jmodel, **kw)
    port = FenixSystem(FenixConfig(batch_size=BATCH,
                                   control_plane_every=CPE, driver=driver),
                       tmodel, device="cpu", **kw)
    return ref, port


def _same_run(a, va, b, vb, where):
    assert np.array_equal(va, vb), where
    assert a.stats == b.stats, where
    assert a.host_syncs == b.host_syncs == 0, where
    for name in ("state", "queues", "_dl"):
        assert_same(dict(getattr(a, name)), dict(getattr(b, name)),
                    f"{where} {name}")


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("model_name", ["bylen", "int8_rnn_tiny"])
def test_streaming_replay_matches_dict_and_reference(capture, rnn_pair,
                                                     model_name, overlap):
    """TraceSpec(pcap) streamed in blocks of eight chunks (two full
    blocks, a short one and a ragged tail, parsed 300 packets at a time)
    == the port's in-memory replay == the reference's streaming replay:
    verdicts, stats, tables, queues and delay line."""
    pcap, stream = capture
    ref, port = _pair(model_name, rnn_pair)
    spec = dict(chunk_pkts=300, overlap=overlap)
    v_ref = np.asarray(ref.run_trace(jti.TraceSpec(pcap, **spec))["verdict"])
    v = port.run_trace(tti.TraceSpec(pcap, **spec))["verdict"]
    assert v.dtype == np.int32 and v.shape == (LIMIT,)
    _same_run(ref, v_ref, port, v, f"{model_name} overlap={overlap}")
    _, mem = _pair(model_name, rnn_pair)
    v_mem = mem.run_trace(dict(stream))["verdict"]
    _same_run(mem, v_mem, port, v, "streamed vs in memory")
    assert ref.stats["inferences"] > 0


def test_streaming_two_calls_and_a_bare_path(capture, rnn_pair):
    """A bare path string and an os.PathLike stream too; two streamed
    calls in a row continue the carry as the reference's do."""
    pcap, _ = capture
    ref, port = _pair("int8_rnn_tiny", rnn_pair)
    for trace in (str(pcap), Path(pcap)):
        v_ref = np.asarray(ref.run_trace(trace)["verdict"])
        v = port.run_trace(trace)["verdict"]
        _same_run(ref, v_ref, port, v, f"{type(trace).__name__}")
    assert port.stats["packets"] == 2 * LIMIT


def test_streaming_producer_error_is_raised_to_the_caller(capture):
    """A capture that breaks off after whole blocks: the producer's
    TraceFormatError reaches run_trace, in either staging mode."""
    raw = capture[0].read_bytes()
    for overlap in (True, False):
        port = FenixSystem(FenixConfig(batch_size=BATCH,
                                       control_plane_every=CPE),
                           ByLenModel(), device="cpu")
        spec = tti.TraceSpec(io.BytesIO(raw[:-5]), chunk_pkts=256,
                             overlap=overlap)
        with pytest.raises(ttf.TraceFormatError,
                           match="truncated pcap record body"):
            port.run_trace(spec)


def test_tracespec_with_oracle_or_host_driver_loads_whole(capture, flows):
    """With oracle payloads a TraceSpec is loaded whole and replayed in
    memory (as in the reference); so is it on the host driver."""
    pcap, stream = capture
    oracle = [np.stack([f.pkt_len, f.ipd_us], -1).astype(np.int32)
              for f in flows]
    for driver, kw in (("device", dict(oracle_windows=oracle)),
                       ("host", {})):
        ref, port = _pair("bylen", None, driver, **kw)
        spec = dict(chunk_pkts=300)
        v_ref = np.asarray(ref.run_trace(jti.TraceSpec(pcap, **spec))
                           ["verdict"])
        v = port.run_trace(tti.TraceSpec(pcap, **spec))["verdict"]
        assert np.array_equal(v, v_ref), driver
        assert port.stats == ref.stats, driver
        _, mem = _pair("bylen", None, driver, **kw)
        assert np.array_equal(mem.run_trace(dict(stream))["verdict"], v)


def test_run_trace_deprecated_spellings_warn_as_in_the_reference(capture):
    pcap, stream = capture
    sys_ = FenixSystem(FenixConfig(batch_size=BATCH), ByLenModel(),
                       device="cpu")
    with pytest.warns(DeprecationWarning, match="deprecated"):
        assert len(sys_.run_trace(stream=dict(stream))["verdict"]) == LIMIT
    with pytest.warns(DeprecationWarning, match="deprecated"):
        assert len(sys_.run_trace(source=pcap, limit=256)["verdict"]) == 256
    with pytest.warns(DeprecationWarning, match="trace_labels"):
        sys_.run_trace(source=str(pcap), limit=10,
                       **{"trace_labels": None})
    with pytest.raises(ValueError, match="exactly one trace"):
        sys_.run_trace()
    with pytest.raises(ValueError, match="exactly one trace"):
        with pytest.warns(DeprecationWarning):
            sys_.run_trace(dict(stream), stream=dict(stream))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        sys_.run_trace(dict(stream))
        sys_.run_trace(tti.TraceSpec(pcap, limit=300))
    assert not [w for w in rec
                if issubclass(w.category, DeprecationWarning)]
    assert os.path.exists(tti.sidecar_path(pcap))
